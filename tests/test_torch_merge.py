"""Port ``ops/merge.py`` against the JAX package's, exact on identical inputs
(host numpy on both sides: equal arrays, equal keys, equal order)."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from amyloid_yolo_tpu.ops import merge as jax_merge
from amyloid_yolo_tpu_torch.ops import merge


def pixel_set_overlap(b1, b2):
    """The original O(area) pixel-set test (``core.py:326-364``)."""
    x1, y1, w1, h1 = b1
    x2, y2, w2, h2 = b2
    p1 = {(x, y) for x in range(x1, x1 + w1) for y in range(y1, y1 + h1)}
    p2 = {(x, y) for x in range(x2, x2 + w2) for y in range(y2, y2 + h2)}
    if not p1 & p2:
        return False, None
    allp = p1 | p2
    xs = [p[0] for p in allp]
    ys = [p[1] for p in allp]
    return True, (min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys))


def random_dets(rng, n, extent=400, classes=(0.0, 1.0)):
    """Clustered (N, 7) detections so merges chain: boxes of 5–80 px around
    a few centres, fractional coordinates, conf in (0.3, 1)."""
    centres = rng.uniform(0, extent, (max(1, n // 4), 2))
    c = centres[rng.randint(0, len(centres), n)] + rng.normal(0, 25, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    rows = np.concatenate([c - wh / 2, c + wh / 2, rng.uniform(0.3, 1, (n, 2)),
                           rng.choice(classes, (n, 1))], axis=1)
    return rows.astype(np.float32)


def edge_dets(rng, n, tile):
    """(N, 7) tile-local detections whose centres lie near the tile's edges,
    so boxes of neighbouring tiles overlap or abut in slide space."""
    c = rng.choice([0.0, tile], (n, 2)) + rng.normal(0, 12, (n, 2))
    c[rng.rand(n) < 0.5, 0] = rng.uniform(0, tile, 1)  # some along an edge
    wh = rng.uniform(8, 40, (n, 2))
    rows = np.concatenate([np.clip(c - wh / 2, 0, tile - 1), np.clip(c + wh / 2, 0, tile - 1),
                           rng.uniform(0.3, 1, (n, 2)), rng.choice([0.0, 1.0], (n, 1))], axis=1)
    return rows.astype(np.float32)


def test_combine_matches_pixel_sets_and_jax(rng):
    for _ in range(300):
        b1 = tuple(int(v) for v in rng.randint(-5, 30, 2)) + tuple(int(v) for v in rng.randint(0, 15, 2))
        b2 = tuple(int(v) for v in rng.randint(-5, 30, 2)) + tuple(int(v) for v in rng.randint(0, 15, 2))
        got = merge.combine_if_overlapping(b1, b2)
        assert got == jax_merge.combine_if_overlapping(b1, b2)
        want = pixel_set_overlap(b1, b2)
        assert got[0] == want[0]
        if got[0]:
            assert got[1] == want[1]


def test_touching_boxes_do_not_merge():
    assert merge.combine_if_overlapping((0, 0, 10, 10), (10, 0, 10, 10))[0] is False
    ok, nb = merge.combine_if_overlapping((0, 0, 10, 10), (9, 0, 10, 10))
    assert ok and nb == (0, 0, 18, 9)  # the original's -1 px union


def test_merge_detections_basic():
    dets = np.array([
        [100, 100, 140, 140, 0.9, 0.95, 1.0],
        [130, 130, 170, 170, 0.7, 0.80, 1.0],
        [400, 400, 420, 420, 0.85, 0.9, 1.0],
        [100, 100, 140, 140, 0.6, 0.7, 0.0],
    ], np.float32)
    out = merge.merge_detections(dets)
    np.testing.assert_array_equal(out, jax_merge.merge_detections(dets))
    merged = [r for r in out if r[0] == 100 and r[6] == 1.0][0]
    assert merged[2] == 169 and merged[3] == 169
    assert np.isclose(merged[4], 0.7) and np.isclose(merged[5], 0.8)


def test_merge_to_fixed_point_chain():
    dets = np.array([[0, 0, 10, 10, 0.9, 0.9, 1.0],
                     [8, 0, 18, 10, 0.8, 0.8, 1.0],
                     [16, 0, 26, 10, 0.7, 0.7, 1.0]], np.float32)
    out = merge.merge_detections(dets)
    assert out.shape == (1, 7) and out[0, 4] == np.float32(0.7)
    np.testing.assert_array_equal(out, jax_merge.merge_detections(dets))


def test_merge_empty():
    out = merge.merge_detections(np.zeros((0, 7), np.float32))
    assert out.shape == (0, 7) and out.dtype == np.float32


@pytest.mark.parametrize("seed", range(8))
def test_merge_detections_matches_jax(seed):
    rng = np.random.RandomState(seed)
    dets = random_dets(rng, int(rng.randint(1, 48)))
    got = merge.merge_detections(dets)
    want = jax_merge.merge_detections(dets)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


box = st.tuples(st.integers(0, 60), st.integers(0, 60), st.integers(0, 30),
                st.integers(0, 30), st.floats(0.25, 1.0, width=32),
                st.floats(0.25, 1.0, width=32), st.sampled_from([0.0, 1.0, 2.0]))


@settings(max_examples=60, deadline=None)
@given(st.lists(box, max_size=14))
def test_merge_detections_matches_jax_hypothesis(rows):
    dets = np.array([[x, y, x + w, y + h, c, cc, k] for x, y, w, h, c, cc, k in rows],
                    np.float32).reshape(-1, 7)
    np.testing.assert_array_equal(merge.merge_detections(dets),
                                  jax_merge.merge_detections(dets))


def test_combine_overlapping_bboxes_label_rule():
    mapp = {"img": [((0, 0, 10, 10), (1, 0, 0)), ((5, 5, 10, 10), (1, 0, 1)),
                    ((100, 100, 10, 10), (0, 0, 1))]}
    out = merge.combine_overlapping_bboxes(mapp)
    assert out == jax_merge.combine_overlapping_bboxes(mapp)
    assert len(out["img"]) == 2
    assert [e for e in out["img"] if e[0][0] == 0][0][1] == (1, 0, 0)  # first label wins


@pytest.mark.parametrize("seed", range(4))
def test_combine_overlapping_bboxes_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    mapp = {}
    for name in ("a", "b", "c"):
        n = int(rng.randint(0, 16))
        mapp[name] = [((int(rng.randint(0, 200)), int(rng.randint(0, 200)),
                        int(rng.randint(1, 60)), int(rng.randint(1, 60))),
                       tuple(int(v) for v in rng.randint(0, 2, 3))) for _ in range(n)]
    assert merge.combine_overlapping_bboxes(mapp) == jax_merge.combine_overlapping_bboxes(mapp)


@pytest.mark.parametrize("seed", range(4))
def test_merge_wsi_detections_matches_jax(seed):
    """Boxes near the edges of a 2×2 grid of 256² tiles, one tile without an
    origin (its rows pass through), one without detections."""
    rng = np.random.RandomState(200 + seed)
    tile = 256
    origins = {f"t{i}{j}": (j * tile, i * tile) for i in range(2) for j in range(2)}
    origins["loose"] = None
    dets_by_path = {p: edge_dets(rng, int(rng.randint(4, 14)), tile) for p in origins}
    dets_by_path["t11"] = None
    rows, owners = merge.merge_wsi_detections(dets_by_path, origins, tile_size=tile)
    want_rows, want_owners = jax_merge.merge_wsi_detections(dets_by_path, origins,
                                                            tile_size=tile)
    np.testing.assert_array_equal(rows, want_rows)
    assert owners == want_owners
