"""Port head decoding against the JAX package.

torch's and XLA's f32 ``sigmoid``/``exp`` differ by up to one ulp on some
inputs, so decoded rows are held to ``rtol`` 1e-6 (a few f32 ulp) or 1e-4 px, while the
selected top-k indices, padding and candidate counts must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.graphspec import yolov3_spec as jax_yolov3_spec
from amyloid_yolo_tpu.models import heads as jax_heads
from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
from amyloid_yolo_tpu_torch.models import heads as port_heads

IMG = 416
RTOL, ATOL = 1e-6, 1e-4  # 1e-4 px: ulp-level exp drift after the xyxy subtraction


def _maps(seed, b=2, tie=False):
    rng = np.random.RandomState(seed)
    maps = [rng.normal(0, 1.5, (b, g, g, 21)).astype(np.float32) for g in (13, 26, 52)]
    if tie:  # whole blocks of identical logits: equal scores everywhere
        for m in maps:
            m[:, ::2, :, :] = 0.7
            m[..., 4::7] = 2.0
    return maps


def _both(maps):
    return [jnp.asarray(m) for m in maps], [torch.from_numpy(m) for m in maps]


def test_decode_all_matches():
    jm, tm = _both(_maps(0))
    want = np.asarray(jax_heads.decode_all(jm, jax_yolov3_spec(), IMG))
    got = port_heads.decode_all(tm, yolov3_spec(), IMG).numpy()
    assert got.shape == want.shape == (2, 3 * (13 ** 2 + 26 ** 2 + 52 ** 2), 7)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("conf_thres", [0.0, 0.5, 0.8, 0.999])
@pytest.mark.parametrize("pool", [64, 256])
def test_decode_topk_matches(conf_thres, pool, tie):
    jm, tm = _both(_maps(1, tie=tie))
    det_j, sc_j, n_j = jax_heads.decode_topk(jm, jax_yolov3_spec(), IMG, conf_thres, pool,
                                             return_count=True)
    det_p, sc_p, n_p = port_heads.decode_topk(tm, yolov3_spec(), IMG, conf_thres, pool)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    sc_j = np.asarray(sc_j)
    np.testing.assert_array_equal(np.isinf(sc_p.numpy()), np.isinf(sc_j))
    np.testing.assert_allclose(sc_p.numpy(), sc_j, rtol=RTOL)
    # identical selection: class, and boxes within a few ulp
    det_j = np.asarray(det_j)
    np.testing.assert_array_equal(det_p[..., 6].numpy(), det_j[..., 6])
    np.testing.assert_allclose(det_p.numpy(), det_j, rtol=RTOL, atol=ATOL)


def test_ties_follow_index_order():
    """Equal scores are taken in index order, as ``lax.top_k`` does."""
    maps = [np.zeros((1, g, g, 21), np.float32) for g in (13, 26, 52)]
    _, tm = _both(maps)
    det, scores, n = port_heads.decode_topk(tm, yolov3_spec(), IMG, 0.3, 8)
    assert torch.all(scores == 0.25) and int(n[0]) == 3 * (13 ** 2 + 26 ** 2 + 52 ** 2)
    # first eight rows of head 0, anchor 0: grid cells (0, 0) .. (0, 7)
    centres = (det[0, :, 0] + det[0, :, 2]) / 2
    np.testing.assert_allclose(centres.numpy(), 0.5 * 32 + 32 * np.arange(8), rtol=1e-6)
