"""The port's letterbox inverses against the JAX package's on the same
inputs: the host ``rescale_boxes`` (ragged rows, float64) against
``amyloid_yolo_tpu.ops.boxes.rescale_boxes`` at rtol 1e-12, and the
batched tensor form ``rescale_boxes_batched`` against ``rescale_boxes_jnp``
at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.ops import boxes as jax_boxes
from amyloid_yolo_tpu_torch.ops import boxes


def _rows(rng, n: int, dim: int = 416) -> np.ndarray:
    """``n`` detection rows of 7 columns in the ``dim`` frame: x1, y1, x2,
    y2, conf, class conf, class."""
    xy = rng.uniform(0, dim, (n, 2))
    wh = rng.uniform(2, dim / 4, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0.3, 1, (n, 2)),
                           rng.randint(0, 2, (n, 1))], axis=1).astype(np.float32)


@pytest.mark.parametrize("shape,n", [((1536, 1536), 23), ((600, 800), 9),
                                     ((800, 600), 14), ((1536, 1536), 0)])
def test_host_rescale_matches_jax(shape, n):
    rows = _rows(np.random.RandomState(n), n)
    before = rows.copy()
    got = boxes.rescale_boxes(rows, 416, shape)
    want = jax_boxes.rescale_boxes(rows, 416, shape)
    assert got.dtype == want.dtype == np.float64 and got.shape == rows.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[:, 4:], rows[:, 4:])
    np.testing.assert_array_equal(rows, before)  # the input is not written


@pytest.mark.parametrize("orig", [(1536, 1536), (600, 800)])
def test_batched_rescale_matches_jax(orig):
    rng = np.random.RandomState(orig[1])
    rows = np.stack([_rows(rng, 16) for _ in range(2)])
    want = np.asarray(jax_boxes.rescale_boxes_jnp(jnp.asarray(rows), 416, *orig))
    got = boxes.rescale_boxes_batched(torch.from_numpy(rows), 416, *orig).numpy()
    assert got.shape == rows.shape == (2, 16, 7)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-5)
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    np.testing.assert_array_equal(got[..., 4:], rows[..., 4:])
