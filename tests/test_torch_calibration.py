"""The port's int8 ``Detector``: calibration, sidecars shared with the JAX
package, and detections against the JAX ``Detector`` under shared scales.

Detections: the JAX ``Detector`` compiles its pipeline, so XLA fuses and
reorders the float32 epilogues and head convs; the same valid mask and
classes are required, boxes within ``BOX_ATOL`` px of the 256-px tile
(measured 0.03) and scores within ``SCORE_ATOL`` (measured 3e-5).
"""

import json

import jax
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels import launch_counts

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec

BOX_ATOL = 0.1
SCORE_ATOL = 1e-3
# the reference calibration tests' configuration (tests/test_calibration.py)
SMALL = dict(model_size=64, tile_size=64, host_resize=True)


def _params():
    return jax.tree.map(np.asarray, jax_darknet.init_params(jax.random.PRNGKey(0), mini_spec()))


def _port(precision, **kw):
    spec = port_mini_spec()
    return Detector(spec, params_from_jax(_params(), spec), precision=precision,
                    device="cpu", **{**SMALL, **kw})


def _jax(precision, **kw):
    return JaxDetector(mini_spec(), _params(), precision=precision, fold_bn=True,
                       **{**SMALL, **kw})


def _tiles(seed, lo=0, hi=255, n=2):
    return np.random.RandomState(seed).randint(lo, hi, (n, 64, 64, 3)).astype(np.uint8)


@pytest.mark.parametrize("precision", ["int8_full", "int8_early"])
def test_jax_sidecar_loads_in_the_port_and_back(tmp_path, precision):
    ref = _jax(precision)
    ref.calibrate(_tiles(2), rebuild=False)
    ref_path = str(tmp_path / "jax.json")
    ref.save_calibration(ref_path, meta={"note": "unit"})
    det = _port(precision)
    assert det.load_calibration(ref_path) == ref._act_scales
    assert det._calib_meta == {"note": "unit", "loaded_from": ref_path}

    port_path = str(tmp_path / "port.json")
    det.save_calibration(port_path)
    back = _jax(precision)
    assert back.load_calibration(port_path, rebuild=False) == ref._act_scales
    assert set(json.load(open(port_path))) == set(json.load(open(ref_path)))


def test_sidecar_refuses_another_graph_and_warns_on_geometry(tmp_path):
    det = _port("int8_full")
    det.calibrate(_tiles(3))
    path = det.save_calibration(str(tmp_path / "calib.json"))
    with pytest.raises(ValueError, match="precision"):
        _port("int8_early").load_calibration(path)
    with pytest.raises(ValueError, match="calib_percentile"):
        _port("int8_full", calib_percentile=99.9).load_calibration(path)
    with pytest.raises(ValueError, match="not a calibration sidecar"):
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        _port("int8_full").load_calibration(str(bad))
    with pytest.warns(UserWarning, match="tile_size"):
        _port("int8_full", tile_size=128).load_calibration(path)


@pytest.mark.parametrize("precision", ["int8_full", "int8_early"])
def test_blank_batch_warns_degenerate(precision):
    det = _port(precision)
    with pytest.warns(UserWarning, match="degenerate"):
        det.calibrate(np.zeros((2, 64, 64, 3), np.uint8))
    assert det._act_scales["in"] < Detector.DEGENERATE_SCALE


def test_accumulate_is_elementwise_max():
    a, b = _tiles(1, 0, 120), _tiles(1, 100, 255)
    sa, sb = _port("int8_full").calibrate(a), _port("int8_full").calibrate(b)
    det = _port("int8_full")
    det.calibrate(a)
    acc = det.calibrate(b, accumulate=True, rebuild=False)
    assert set(acc) == set(sa) == set(sb)
    assert acc == {k: max(sa[k], sb[k]) for k in acc}


@pytest.mark.parametrize("precision", ["int8_full", "int8_early"])
def test_scales_match_jax(precision):
    """Each side calibrating on the same batch: float32 ulps apart."""
    tiles = _tiles(4)
    want = _jax(precision).calibrate(tiles, rebuild=False)
    got = _port(precision).calibrate(tiles)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_save_needs_scales_and_an_int8_precision(tmp_path):
    with pytest.raises(ValueError, match="no calibration"):
        _port("int8_full").save_calibration(str(tmp_path / "c.json"))
    with pytest.raises(ValueError, match="has no"):
        _port("bf16").save_calibration(str(tmp_path / "c.json"))
    assert _port("bf16").calibrate(_tiles(0)) == {}


@pytest.mark.parametrize("precision", ["int8_full", "int8_early"])
def test_detections_match_jax_detector(tmp_path, precision):
    """Golden-test configuration at conf 0.3, scales shared through a
    sidecar the JAX ``Detector`` wrote."""
    params = jax_params_np(mini_spec(), 3, bn_noise=True)
    cfg = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)
    tiles = np.random.RandomState(7).randint(0, 255, (2, 256, 256, 3)).astype(np.uint8)
    ref = JaxDetector(mini_spec(), params, precision=precision, **cfg)
    ref.calibrate(tiles)
    path = ref.save_calibration(str(tmp_path / "calib.json"))
    want_d, want_v = (np.asarray(a) for a in ref(tiles))

    det = Detector(port_mini_spec(), params_from_jax(params, port_mini_spec()),
                   precision=precision, device="cpu", **cfg)
    det.load_calibration(path)
    dets, valid = det(tiles)
    v = valid.numpy()
    np.testing.assert_array_equal(v, want_v)
    assert v.sum() > 0
    np.testing.assert_allclose(dets.numpy()[v][:, :4], want_d[v][:, :4], atol=BOX_ATOL)
    np.testing.assert_allclose(dets.numpy()[v][:, 4:6], want_d[v][:, 4:6], atol=SCORE_ATOL)
    np.testing.assert_array_equal(dets.numpy()[v][:, 6], want_d[v][:, 6])
    np.testing.assert_array_equal(det._last_ncand.numpy(), np.asarray(ref._last_ncand))
    assert launch_counts() == {"resize_normalize": 0, "fused_residual_block": 0,
                               "fused_residual_block_int8": 0}


def test_first_call_calibrates_lazily():
    det = _port("int8_early", conf_thres=0.3, capacity=8)
    assert det._act_scales is None
    with pytest.raises(ValueError, match="calibrate"):
        det.head_maps(torch.from_numpy(_tiles(5)))
    dets, valid = det(_tiles(5))
    assert det._act_scales is not None and tuple(dets.shape) == (2, 8, 7)
    want = _port("int8_early").calibrate(_tiles(5))
    assert det._act_scales == want


def test_folder_calibration_not_ported(tmp_path):
    """The name is historical: folder calibration is ported now
    (``tests/test_torch_folder.py`` holds it against the JAX package).  A
    folder without a readable tile leaves the detector uncalibrated, as in
    the reference."""
    from amyloid_yolo_tpu_torch.io.datasets import ImageFolder

    (tmp_path / "bad.jpg").write_bytes(b"nope")
    det = _port("int8_full")
    det._calibrate_from_folder(ImageFolder(str(tmp_path), tile_size=64), 2)
    assert det._act_scales is None and det._calib_meta == {}
