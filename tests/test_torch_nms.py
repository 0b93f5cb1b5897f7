"""Port merging NMS against the JAX package and its host mirror, on the
cases of ``tests/test_nms.py``.

Against the JAX functions on the same f32 inputs the port is held to 1e-5
(the merge sums in another order); against the ragged host mirror to 1e-3,
the tolerance ``tests/test_nms.py`` gives the JAX kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.ops import nms as jax_nms
from amyloid_yolo_tpu_torch.ops import nms as port_nms

TOL = 1e-5


def random_preds(rng, b=3, n=60, c=2):
    pred = np.zeros((b, n, 5 + c), np.float32)
    pred[..., 0:2] = rng.rand(b, n, 2) * 400
    pred[..., 2:4] = rng.rand(b, n, 2) * 80 + 4
    pred[..., 4] = rng.rand(b, n)
    pred[..., 5:] = rng.rand(b, n, c)
    return pred


def _crowded(trial):
    r = np.random.RandomState(trial)
    pred = random_preds(r, b=4, n=80)
    if trial % 2:  # crowd the boxes to force multi-member clusters
        pred[..., 0:2] = r.rand(4, 80, 2) * 120
        pred[..., 2:4] = r.rand(4, 80, 2) * 100 + 20
    return pred


def _assert_ragged_close(got, want, tol):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("trial", range(8))
def test_dense_matches_jax_and_host_mirror(trial):
    pred = _crowded(trial)
    dets, valid, n = port_nms.non_max_suppression(torch.from_numpy(pred), 0.5, 0.4,
                                                  capacity=96, return_count=True)
    jd, jv, jn = jax_nms.non_max_suppression(jnp.asarray(pred), 0.5, 0.4, capacity=96,
                                             return_count=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(dets.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    _assert_ragged_close(port_nms.dense_to_ragged(dets, valid),
                         jax_nms.non_max_suppression_np(pred, 0.5, 0.4), 1e-3)


def test_high_conf_operating_point(rng):
    pred = random_preds(rng, b=2, n=200)
    dets, valid = port_nms.non_max_suppression(torch.from_numpy(pred), 0.8, 0.4, capacity=64)
    _assert_ragged_close(port_nms.dense_to_ragged(dets, valid),
                         jax_nms.non_max_suppression_np(pred, 0.8, 0.4), 1e-3)


def test_merge_weighted_average():
    pred = np.zeros((1, 2, 7), np.float32)
    pred[0, 0] = [100, 100, 40, 40, 0.9, 0.9, 0.1]
    pred[0, 1] = [105, 105, 40, 40, 0.6, 0.8, 0.2]
    dets, valid = port_nms.non_max_suppression(torch.from_numpy(pred), 0.5, 0.4, capacity=4)
    assert valid.tolist() == [[True, False, False, False]]
    a = np.array([80, 80, 120, 120], np.float64)
    b = np.array([85, 85, 125, 125], np.float64)
    np.testing.assert_allclose(dets[0, 0, :4].numpy(), (0.9 * a + 0.6 * b) / 1.5, atol=1e-4)
    assert dets[0, 0, 4].item() == np.float32(0.9)


@pytest.mark.parametrize("capacity,pool", [(16, 64), (8, 120), (64, 64), (64, 16)])
def test_pool_overflow_and_compaction(capacity, pool):
    """Dense crowd: more candidates than the pool; keepers past ``capacity``
    are cut after compaction, in score order; a pool smaller than
    ``capacity`` leaves the tail rows empty."""
    rng = np.random.RandomState(3)
    pred = random_preds(rng, b=2, n=150)
    pred[0, :, 4] = 0.6 + 0.4 * rng.rand(150)    # image 0: all 150 pass
    pred[1, :, 4] = 0.1                          # image 1: none pass
    dets, valid, n = port_nms.non_max_suppression(torch.from_numpy(pred), 0.5, 0.4,
                                                  capacity=capacity, pool=pool,
                                                  return_count=True)
    jd, jv, jn = jax_nms.non_max_suppression(jnp.asarray(pred), 0.5, 0.4, capacity=capacity,
                                             pool=pool, return_count=True)
    assert n.tolist() == [150, 0] == np.asarray(jn).tolist()
    assert tuple(dets.shape) == (2, capacity, 7)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_allclose(dets.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    assert not valid[1].any()


@pytest.mark.parametrize("capacity", [16, 64])
def test_pooled_matches_jax(capacity):
    """The pooled stage alone, on sorted candidate rows with padding."""
    rng = np.random.RandomState(11)
    b, pool = 3, 64
    det = np.zeros((b, pool, 7), np.float32)
    xy = rng.rand(b, pool, 2) * 150
    wh = rng.rand(b, pool, 2) * 60 + 10
    det[..., 0:2], det[..., 2:4] = xy, xy + wh
    det[..., 4] = rng.rand(b, pool)
    det[..., 5] = rng.rand(b, pool)
    det[..., 6] = rng.randint(0, 2, (b, pool))
    scores = -np.sort(-rng.rand(b, pool)).astype(np.float32)
    scores[1, 40:] = -np.inf
    scores[2, :] = -np.inf
    dets, valid = port_nms.non_max_suppression_pooled(
        torch.from_numpy(det), torch.from_numpy(scores), 0.4, capacity)
    jd, jv = jax_nms.non_max_suppression_pooled(jnp.asarray(det), jnp.asarray(scores),
                                                0.4, capacity)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_allclose(dets.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    assert not valid[2].any()


def test_dense_to_ragged():
    dets = torch.arange(2 * 3 * 7, dtype=torch.float32).reshape(2, 3, 7)
    valid = torch.tensor([[True, True, False], [False, False, False]])
    out = port_nms.dense_to_ragged(dets, valid)
    assert out[1] is None
    np.testing.assert_array_equal(out[0], dets[0, :2].numpy())
