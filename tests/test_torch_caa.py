"""The port's CAA filter (``models/classifier.py``, ``domain.py``) against the
JAX package's.  Classifier probabilities within ``PROB_ATOL`` in float32;
keep/drop decisions equal."""

import numpy as np
import pytest
import torch
import torch.nn as nn
from PIL import Image

from amyloid_yolo_tpu import domain as jax_domain
from amyloid_yolo_tpu.models import classifier as jax_classifier
from amyloid_yolo_tpu_torch import domain
from amyloid_yolo_tpu_torch.models import classifier

from torch_port_helpers import jax_classifier_params, stain_crops, stain_tile

PROB_ATOL = 1e-5


class ReferenceNet(nn.Module):
    """The original ``Net`` module (``core.py:161-208``), as in
    ``tests/test_domain.py``; at module level so that it pickles."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for out_ch in classifier.STAGE_WIDTHS:
            layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.BatchNorm2d(out_ch),
                       nn.ReLU(inplace=True), nn.MaxPool2d(2, 2)]
            in_ch = out_ch
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Linear(96 * 4 * 4, 3))

    def forward(self, x):
        x = self.features(x)
        return self.classifier(x.reshape(x.size(0), -1))


def _port_net(params):
    net = classifier.Net()
    net.load_state_dict(classifier.from_jax_params(params))
    return net.eval()


@pytest.mark.parametrize("seed", [0, 1])
def test_classifier_probs_match_jax(seed):
    params = jax_classifier_params(seed, fc_scale=8.0)
    x = stain_crops(seed, 8).astype(np.float32) / 255.0
    want = np.asarray(jax_classifier.predict_probs(params, x))
    got = classifier.predict_probs(_port_net(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    assert (want < 0.5).any() and (want > 0.5).any()  # both sides of 0.5 exercised


def test_reference_state_dict_loads_as_is():
    ref = ReferenceNet().eval()
    net = classifier.Net()
    assert sorted(net.state_dict()) == sorted(ref.state_dict())
    net.load_state_dict(ref.state_dict())  # strict
    x = torch.rand(2, 3, 256, 256)
    with torch.no_grad():
        torch.testing.assert_close(net.eval()(x), ref(x), rtol=0, atol=0)
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert sorted(classifier.from_jax_params(jax_classifier.from_torch_state_dict(sd))) \
        == sorted(sd)


def test_from_torch_pickle_roundtrip(tmp_path):
    ref = ReferenceNet()
    path = str(tmp_path / "model.pkl")
    torch.save(ref, path)
    sd = classifier.from_torch_pickle(path)
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    f = domain.CAAFilter(model_pickle=path, device="cpu")
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(f.net.state_dict()[k], v, rtol=0, atol=0)


def test_init_params_follow_the_reference_scheme():
    sd = classifier.init_params(torch.Generator().manual_seed(0))
    classifier.Net().load_state_dict(sd)
    w0 = sd["features.0.weight"]
    assert abs(w0.std().item() - np.sqrt(2 / 27)) < 0.05
    assert abs(sd["classifier.0.weight"].std().item() - 0.01) < 0.001


def test_load_normalization(tmp_path):
    mean, std = classifier.load_normalization(None)
    assert mean.tolist() == [0, 0, 0] and std.tolist() == [1, 1, 1]
    stub = tmp_path / "stub.npy"
    stub.write_text("version https://git-lfs.github.com/spec/v1\n")
    assert classifier.load_normalization(str(stub))[1].tolist() == [1, 1, 1]
    real = tmp_path / "norm.npy"
    np.save(real, {"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.2, 0.25]}, allow_pickle=True)
    mean, std = classifier.load_normalization(str(real))
    jmean, jstd = jax_classifier.load_normalization(str(real))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(std.numpy(), np.asarray(jstd))


def _dets(rng, n, side=1536):
    xy = rng.uniform(-40, side, (n, 2))
    wh = rng.uniform(10, 300, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0.3, 1, (n, 2)),
                           rng.randint(0, 2, (n, 1))], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed,n", [(0, 6), (1, 11), (2, 1)])
def test_caa_filter_decisions_match_jax(seed, n):
    rng = np.random.RandomState(seed)
    params = jax_classifier_params(seed, fc_scale=8.0)
    img = stain_tile(rng, 1536, 1536)
    dets = _dets(rng, n)
    ref = jax_domain.CAAFilter(params)
    f = domain.CAAFilter(classifier.from_jax_params(params), device="cpu")
    crops = np.stack([domain._crop(img, r) for r in dets])
    np.testing.assert_array_equal(crops, np.stack([jax_domain._crop(img, r) for r in dets]))
    np.testing.assert_allclose(f.predict_crops(crops), ref.predict_crops(crops),
                               atol=PROB_ATOL, rtol=0)
    got, want = f(img, dets), ref(img, dets)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # Cored never touched; CAA kept iff p(CAA) > 0.5
    probs = f.predict_crops(crops)
    kept = [r for r, p in zip(dets, probs) if r[6] == 1.0 or p[2] > 0.5]
    np.testing.assert_array_equal(got, np.asarray(kept, np.float32).reshape(-1, 7))


def test_caa_filter_keeps_and_drops():
    """Across a spread of crops, some CAA rows survive and some do not."""
    rng = np.random.RandomState(5)
    f = domain.CAAFilter(classifier.from_jax_params(jax_classifier_params(3, 8.0)),
                         device="cpu")
    img = stain_tile(rng, 1536, 1536)
    dets = _dets(rng, 24)
    dets[:, 6] = 0.0  # all CAA
    assert 0 < len(f(img, dets)) < len(dets)
    assert f(img, dets[:0]).shape == (0, 7)


@pytest.mark.parametrize("k", [3, 9, 130])
def test_crop_buckets_match_jax(k):
    """Batches padded to 8, 32 (and 130 > 128 left as is) give the same
    probabilities as the JAX package's."""
    params = jax_classifier_params(1, fc_scale=8.0)
    crops = stain_crops(k, k)
    f = domain.CAAFilter(classifier.from_jax_params(params), device="cpu")
    got = f.predict_crops(crops)
    assert got.shape == (k, 3)
    np.testing.assert_allclose(got, jax_domain.CAAFilter(params).predict_crops(crops),
                               atol=PROB_ATOL, rtol=0)


def test_filter_path_matches_jax(tmp_path):
    """A small border-like JPEG and a PNG: the native 1536² frame or PIL
    give the same crops, so the same decisions as the JAX package's."""
    rng = np.random.RandomState(9)
    params = jax_classifier_params(2, fc_scale=8.0)
    f = domain.CAAFilter(classifier.from_jax_params(params), device="cpu")
    ref = jax_domain.CAAFilter(params)
    img = stain_tile(rng, 400, 600)
    jpg, png = str(tmp_path / "b.jpg"), str(tmp_path / "b.png")
    Image.fromarray(img).save(jpg, quality=95)
    Image.fromarray(img).save(png)
    dets = _dets(rng, 8, side=600)
    for path in (jpg, png):
        np.testing.assert_array_equal(f.filter_path(path, dets), ref.filter_path(path, dets))
    assert f.filter_path(png, dets[:0]).shape == (0, 7)


def test_caa_filter_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        domain.CAAFilter()
