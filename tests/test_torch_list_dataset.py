"""The port's ``ListDataset`` against the JAX package's (``io/datasets.py``):
the same batches, bit for bit, over two epochs (shuffle, multiscale sizes,
padded targets and masks), a corrupt image and a missing label file
dropped, and ``cache_images`` and ``host_resize`` bit-identical to the
plain reads.  The port decodes JPEGs with its native reader where it is
built and with PIL otherwise; the JAX package decodes with PIL; the pixels
are equal either way (``test_torch_native.py``)."""

import io
import contextlib

import numpy as np
import pytest
from PIL import Image

from amyloid_yolo_tpu.io.datasets import ListDataset as JaxListDataset
from amyloid_yolo_tpu_torch.io.datasets import ListDataset
from amyloid_yolo_tpu_torch.ops.preprocess import nearest_indices

from torch_port_helpers import stain_tile

N_GOOD = 22


@pytest.fixture(scope="module")
def train_list(tmp_path_factory):
    """22 readable JPEG tiles (some not square) with 0-3 labels, one
    corrupt image and one image without a label file."""
    root = tmp_path_factory.mktemp("listds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(N_GOOD):
        h, w = (48, 48) if i % 3 else (36, 48)  # pads to 48² too
        p = root / "images" / f"t{i:02d}.jpg"
        Image.fromarray(stain_tile(rng, h, w)).save(p, quality=90)
        n = i % 4
        rows = [f"{rng.randint(0, 2)} {rng.uniform(0.2, 0.8):.4f} {rng.uniform(0.2, 0.8):.4f} "
                f"{rng.uniform(0.05, 0.3):.4f} {rng.uniform(0.05, 0.3):.4f}" for _ in range(n)]
        (root / "labels" / f"t{i:02d}.txt").write_text("\n".join(rows) + ("\n" if n else ""))
        paths.append(str(p))
    (root / "images" / "bad.jpg").write_bytes(b"not a jpeg")
    (root / "labels" / "bad.txt").write_text("0 0.5 0.5 0.1 0.1\n")
    nolabel = root / "images" / "nolabel.jpg"
    Image.fromarray(stain_tile(rng, 48, 48)).save(nolabel, quality=90)
    paths[5:5] = [str(root / "images" / "bad.jpg")]
    paths[12:12] = [str(nolabel)]
    (root / "train.txt").write_text("\n".join(paths) + "\n")
    return str(root / "train.txt")


def _epochs(ds, n_epochs=2, batch=2):
    out = []
    with contextlib.redirect_stdout(io.StringIO()) as log:
        for _ in range(n_epochs):
            out.append(list(ds.iter_epoch(batch)))
    return out, log.getvalue()


def _assert_same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for x, y in zip(ea, eb):
            assert x["paths"] == y["paths"] and x["img_size"] == y["img_size"]
            for k in ("images", "targets", "target_mask"):
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_batches_bit_equal_to_jax_over_two_epochs(train_list):
    kw = dict(img_size=416, multiscale=True, augment=True, seed=3)
    got, log = _epochs(ListDataset(train_list, **kw))
    want, jlog = _epochs(JaxListDataset(train_list, **kw))
    _assert_same(got, want)
    sizes = [b["img_size"] for e in got for b in e]
    assert len(sizes) == 24 and sizes[:9] == [416] * 9
    assert len(set(sizes)) > 1                               # the schedule moved
    assert got[0][0]["paths"] != got[1][0]["paths"]          # reshuffled per epoch
    assert log == jlog


def test_corrupt_image_and_missing_label_dropped(train_list):
    (epoch,), log = _epochs(ListDataset(train_list, multiscale=False, seed=1), 1)
    assert "Could not read image" in log and "bad.jpg" in log
    assert "Could not read label" in log and "nolabel.txt" in log
    paths = [p for b in epoch for p in b["paths"]]
    assert len(paths) == N_GOOD and not any("bad" in p or "nolabel" in p for p in paths)
    for b in epoch:
        n = len(b["paths"])
        assert b["images"].shape[0] == n and b["targets"].shape == (n * 100, 6)
        rows = b["targets"][b["target_mask"]]
        assert set(rows[:, 0].astype(int)) <= set(range(n))


def test_cache_images_and_host_resize_bit_identical(train_list):
    kw = dict(img_size=128, multiscale=True, seed=5)  # sizes 32-224
    plain, _ = _epochs(ListDataset(train_list, **kw))
    cached, _ = _epochs(ListDataset(train_list, cache_images=True, **kw))
    _assert_same(cached, plain)
    resized, _ = _epochs(ListDataset(train_list, host_resize=True, **kw))
    jresized, _ = _epochs(JaxListDataset(train_list, host_resize=True, **kw))
    _assert_same(resized, jresized)
    for ep, er in zip(plain, resized):
        for bp, br in zip(ep, er):
            idx = nearest_indices(bp["img_size"], bp["images"].shape[1])
            assert np.array_equal(br["images"], bp["images"][:, idx][:, :, idx])
            assert np.array_equal(br["targets"], bp["targets"])


def test_size_schedule_and_probe(train_list):
    ds, jds = ListDataset(train_list, seed=9), JaxListDataset(train_list, seed=9)
    assert [ds.size_for_count(c) for c in range(1, 60)] == \
        [jds.size_for_count(c) for c in range(1, 60)]
    assert {ds.size_for_count(c) for c in range(10, 400)} <= set(range(320, 513, 32))
    assert ds.probe_native_side() == jds.probe_native_side() == 48
