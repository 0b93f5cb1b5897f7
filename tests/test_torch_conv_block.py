"""K2's plain version against the JAX Pallas kernel in interpret mode, on the
cases of ``tests/test_pallas_conv_block.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.pallas.conv_block import fused_residual_block as jax_block
from amyloid_yolo_tpu.pallas.conv_block import pack_block_weights as jax_pack
from amyloid_yolo_tpu_torch.kernels.conv_block import (
    fused_residual_block,
    pack_block_weights,
)

F32_TOL = 1e-5
# bf16: products and sums are f32 in both, in another order, so a hidden or
# output value may round to the neighbouring bf16: one ulp, 2^-7 relative
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6


def _case(rng, b, h, w, c, c2):
    x = rng.randn(b, h, w, c).astype(np.float32)
    w1 = (0.2 * rng.randn(1, 1, c, c2)).astype(np.float32)
    b1 = rng.randn(c2).astype(np.float32)
    w2 = (0.2 * rng.randn(3, 3, c2, c)).astype(np.float32)
    b2 = rng.randn(c).astype(np.float32)
    return x, w1, b1, w2, b2


def _port_pack(w1, b1, w2, b2, dtype):
    oihw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))  # noqa: E731
    return pack_block_weights(oihw(w1), torch.from_numpy(b1), oihw(w2),
                              torch.from_numpy(b2), dtype)


@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 4), (1, 13, 13, 64, 32)])
def test_plain_matches_pallas_f32(rng, shape):
    x, w1, b1, w2, b2 = _case(rng, *shape)
    want = jax_block(jnp.asarray(x), *jax_pack(w1, b1, w2, b2), interpret=True)
    got = fused_residual_block(torch.from_numpy(x), *_port_pack(w1, b1, w2, b2, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", [(1, 8, 8, 16, 8), (2, 7, 9, 64, 32), (1, 20, 20, 128, 64)])
def test_plain_matches_pallas_bf16(rng, shape):
    x, w1, b1, w2, b2 = _case(rng, *shape)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_block(xb, *jax_pack(w1, b1, w2, b2), interpret=True), np.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = fused_residual_block(xt, *_port_pack(w1, b1, w2, b2, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert fused_residual_block.launches == 0  # CPU tensors never launch the kernel


def test_pack_layout(rng):
    _, w1, b1, w2, b2 = _case(rng, 1, 1, 1, 8, 4)
    w1t, b1t, w2t, b2t = _port_pack(w1, b1, w2, b2, torch.float32)
    assert tuple(w1t.shape) == (4, 8) and tuple(w2t.shape) == (9, 8, 4)
    np.testing.assert_array_equal(w1t.numpy(), w1[0, 0].T)
    for di in range(3):
        for dj in range(3):
            np.testing.assert_array_equal(w2t[3 * di + dj].numpy(), w2[di, dj].T)
    assert b1t.dtype == torch.float32 and b2t.dtype == torch.float32


def test_rejects_mismatched_weights(rng):
    x, w1, b1, w2, b2 = _case(rng, 1, 4, 4, 8, 4)
    w1t, b1t, w2t, b2t = _port_pack(w1, b1, w2, b2, torch.float32)
    with pytest.raises(ValueError):
        fused_residual_block(torch.from_numpy(x)[..., :6], w1t, b1t, w2t, b2t)
    with pytest.raises(ValueError):
        fused_residual_block(torch.from_numpy(x)[0], w1t, b1t, w2t, b2t)
