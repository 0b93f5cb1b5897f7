"""The port's ``domain.py`` helpers of the CLI against the JAX package's:
the drawings pixel-equal, the CAA-detections pickle equal (with the
original's centre quirk), ``wsis_with_most_caas`` and ``clear_output_dir``."""

import os
import pickle

import numpy as np
import pytest

from amyloid_yolo_tpu import domain as jax_domain
from amyloid_yolo_tpu_torch import domain

from torch_port_helpers import stain_tile


def _rows(rng, n, side=256):
    xy = rng.uniform(-20, side, (n, 2))
    wh = rng.uniform(2, 90, (n, 2))
    return np.concatenate([xy, xy + wh, rng.rand(n, 2), rng.randint(0, 2, (n, 1))],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_detections_pixel_equal(seed):
    rng = np.random.RandomState(seed)
    img = stain_tile(rng, 256, 200)
    rows = _rows(rng, 12)
    for classes in (("CAA", "Cored"), ("Cored", "Other")):
        got = domain.draw_detections(img, rows, classes)
        np.testing.assert_array_equal(got, jax_domain.draw_detections(img, rows, classes))
        assert (got != img).any()
    np.testing.assert_array_equal(domain.draw_detections(img, rows[:0]), img)


@pytest.mark.parametrize("color_by_class", [False, True])
def test_draw_bboxes_pixel_equal(color_by_class):
    rng = np.random.RandomState(4)
    img = stain_tile(rng, 300, 300)
    entries = [([int(x), int(y), int(w), int(h)], tuple(p)) for x, y, w, h, p in zip(
        rng.randint(0, 280, 10), rng.randint(0, 280, 10), rng.randint(4, 60, 10),
        rng.randint(4, 60, 10), rng.rand(10, 3))]
    got = domain.draw_bboxes(img, entries, color_by_class=color_by_class)
    np.testing.assert_array_equal(
        got, jax_domain.draw_bboxes(img, entries, color_by_class=color_by_class))
    assert (got != img).any()


def test_write_caa_detections_pickle_equal(tmp_path):
    for side, mod in (("p", domain), ("j", jax_domain)):
        path = str(tmp_path / f"{side}.pkl")
        mod.write_caa_detections(path, "/a/b/tile_1.jpg", _rows(np.random.RandomState(6), 9))
        mod.write_caa_detections(path, "/a/b/tile_1.jpg", _rows(np.random.RandomState(7), 4))
        mod.write_caa_detections(path, "tile_2.jpg", _rows(np.random.RandomState(8), 5),
                                 classes=("Cored", "CAA"))
    with open(tmp_path / "p.pkl", "rb") as a, open(tmp_path / "j.pkl", "rb") as b:
        got, want = pickle.load(a), pickle.load(b)
    assert got == want and sorted(got) == ["tile_1.jpg", "tile_2.jpg"]
    # the original's quirk: the centre is half the box size, not its position
    caa_rows = _rows(np.random.RandomState(6), 9)
    first = caa_rows[caa_rows[:, 6] == 0][0]
    assert got["tile_1.jpg"][0] == (0, (int(first[2]) - int(first[0])) / 2.0,
                                    (int(first[3]) - int(first[1])) / 2.0,
                                    int(first[2]) - int(first[0]), int(first[3]) - int(first[1]))


def test_wsis_with_most_caas_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    counts = {f"W{i}": {"Cored": int(rng.randint(0, 50)), "CAA": int(rng.randint(0, 5))}
              for i in range(20)}
    counts["W_none"] = {"Cored": 3}
    path = str(tmp_path / "counts.pkl")
    with open(path, "wb") as fh:
        pickle.dump(counts, fh)
    for n in (0, 1, 5, 12, 40):
        assert domain.wsis_with_most_caas(path, n) == jax_domain.wsis_with_most_caas(path, n)
    assert len(domain.wsis_with_most_caas(path)) == 12


def test_clear_output_dir_matches_jax(tmp_path):
    for side, mod in (("p", domain), ("j", jax_domain)):
        out = tmp_path / side / "out"
        mod.clear_output_dir(str(out))  # absent: created
        (out / "sub").mkdir()
        (out / "x.png").write_bytes(b"x")
        mod.clear_output_dir(str(out))  # present: emptied
        assert os.listdir(out) == []
