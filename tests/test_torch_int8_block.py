"""K3's plain version against the JAX package's integer-math oracle
``reference_block_int8`` and its Pallas kernel in interpret mode, on the
cases of ``tests/test_pallas_int8_block.py``: bit-exact (integer products
are exact; the float32 epilogue rounds at the same points)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.pallas.int8_block import fused_residual_block_int8 as jax_block
from amyloid_yolo_tpu.pallas.int8_block import pack_int8_block as jax_pack
from amyloid_yolo_tpu.pallas.int8_block import reference_block_int8
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels import launch_counts
from amyloid_yolo_tpu_torch.kernels.int8_block import (
    fused_residual_block_int8,
    pack_int8_block,
    pack_model_int8_units,
)
from amyloid_yolo_tpu_torch.models import darknet as port_darknet

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec

SX, S1, S_OUT = 0.011, 0.017, 0.023


def _unit(rng, c, c2):
    """The reference test's ranges: int8 weights, scales in [1e-3, 2e-2),
    biases in ±1; HWIO for JAX."""
    w1q = rng.randint(-127, 128, (1, 1, c, c2)).astype(np.int8)
    w2q = rng.randint(-127, 128, (3, 3, c2, c)).astype(np.int8)
    ws1 = rng.uniform(1e-3, 2e-2, c2).astype(np.float32)
    ws2 = rng.uniform(1e-3, 2e-2, c).astype(np.float32)
    b1 = rng.uniform(-1, 1, c2).astype(np.float32)
    b2 = rng.uniform(-1, 1, c).astype(np.float32)
    return w1q, ws1, b1, w2q, ws2, b2


def _both(rng, b, h, w, c, c2):
    w1q, ws1, b1, w2q, ws2, b2 = _unit(rng, c, c2)
    xq = rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    jw1, ja1, jb1, jw2, ja2, jb2 = jax_pack(w1q, ws1, b1, w2q, ws2, b2)
    jax_args = (jnp.asarray(xq), jw1, ja1 * SX, jb1, jw2, ja2 * S1, jb2)

    def oihw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))

    w1t, pws1, pb1, w2t, pws2, pb2 = pack_int8_block(
        oihw(w1q), torch.from_numpy(ws1), torch.from_numpy(b1),
        oihw(w2q), torch.from_numpy(ws2), torch.from_numpy(b2))
    port_args = (torch.from_numpy(xq), w1t, pws1 * SX, pb1, w2t, pws2 * S1, pb2)
    return jax_args, port_args


@pytest.mark.parametrize("H,W,C,C2,strip", [
    (16, 16, 128, 64, 8),
    (16, 16, 128, 64, 16),
    (24, 16, 64, 32, 8),
])
def test_plain_matches_reference_bitexact(H, W, C, C2, strip):
    jax_args, port_args = _both(np.random.RandomState(0), 2, H, W, C, C2)
    want = np.asarray(reference_block_int8(*jax_args, sx=SX, s1=S1, s_out=S_OUT))
    got = fused_residual_block_int8(*port_args, sx=SX, s1=S1, s_out=S_OUT, strip=strip)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts()["fused_residual_block_int8"] == 0  # CPU: the plain version


def test_plain_matches_pallas_interpret_bitexact():
    """Odd widths and a map that is not a whole number of warp tiles."""
    jax_args, port_args = _both(np.random.RandomState(3), 2, 13, 11, 64, 32)
    want = np.asarray(jax_block(*jax_args, sx=SX, s1=S1, s_out=S_OUT, strip=13,
                                interpret=True))
    got = fused_residual_block_int8(*port_args, sx=SX, s1=S1, s_out=S_OUT)
    np.testing.assert_array_equal(got.numpy(), want)


def test_strip_must_divide_height():
    _, port_args = _both(np.random.RandomState(1), 1, 20, 16, 64, 32)
    with pytest.raises(ValueError, match="strip"):
        fused_residual_block_int8(*port_args, sx=SX, s1=S1, s_out=S_OUT, strip=8)


def test_rejects_mismatched_weights():
    _, (xq, *pack) = _both(np.random.RandomState(2), 1, 8, 8, 64, 32)
    with pytest.raises(ValueError, match="channels"):
        fused_residual_block_int8(xq[..., :32], *pack, sx=SX, s1=S1, s_out=S_OUT)
    with pytest.raises(ValueError, match="NHWC"):
        fused_residual_block_int8(xq[0], *pack, sx=SX, s1=S1, s_out=S_OUT)


def test_pack_layout():
    w1q, ws1, b1, w2q, ws2, b2 = _unit(np.random.RandomState(4), 8, 4)
    oihw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))  # noqa: E731
    w1t, _, _, w2t, _, _ = pack_int8_block(oihw(w1q), torch.from_numpy(ws1),
                                           torch.from_numpy(b1), oihw(w2q),
                                           torch.from_numpy(ws2), torch.from_numpy(b2))
    assert tuple(w1t.shape) == (4, 8) and tuple(w2t.shape) == (9, 8, 4)
    np.testing.assert_array_equal(w1t.numpy(), w1q[0, 0].T)
    for di in range(3):
        for dj in range(3):
            np.testing.assert_array_equal(w2t[3 * di + dj].numpy(), w2q[di, dj].T)


def test_model_units_carry_the_model_scales():
    """Every fusible unit of the quantized mini model, with sx, s1 and s_out
    the scales of layers i-1, i and i+2, and packs equal to
    :func:`pack_int8_block` of the quantized convs."""
    params = jax_params_np(mini_spec(), 5, bn_noise=True)
    spec = port_mini_spec()
    folded = port_darknet.fold_batchnorm(params_from_jax(params, spec), spec)
    qp = port_darknet.quantize_folded_int8_full(folded, spec)
    scales = {str(i): 0.01 * (i + 1) for i in range(len(spec.layers))}
    units = pack_model_int8_units(qp, scales, spec)
    # unit 2's 3x3 reads 4 channels: int8_full keeps it in bf16 (in_ch < 8)
    assert sorted(jax_darknet.fusible_residual_blocks(mini_spec())) == [2, 6, 10, 14]
    assert "conv_3" not in qp and sorted(units) == [6, 10, 14]
    for i, u in units.items():
        assert (u.sx, u.s1, u.s_out) == (scales[str(i - 1)], scales[str(i)], scales[str(i + 2)])
        w1t, ws1, b1, w2t, ws2, b2 = pack_int8_block(
            *(qp[f"conv_{i}"][k] for k in ("wq", "ws", "b")),
            *(qp[f"conv_{i + 1}"][k] for k in ("wq", "ws", "b")))
        for got, want in zip(u.pack, (w1t, ws1 * u.sx, b1, w2t, ws2 * u.s1, b2)):
            assert torch.equal(got, want)
