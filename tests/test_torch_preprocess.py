"""Port preprocess and K1's plain version against the JAX package: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.ops import preprocess as jax_pre
from amyloid_yolo_tpu_torch.kernels.preprocess_kernel import (
    resize_normalize,
    resize_normalize_plain,
)
from amyloid_yolo_tpu_torch.ops import preprocess as port_pre


@pytest.mark.parametrize("out_size,in_size", [(64, 256), (416, 1536), (416, 416),
                                              (13, 7), (100, 333)])
def test_nearest_indices_match(out_size, in_size):
    np.testing.assert_array_equal(port_pre.nearest_indices(out_size, in_size),
                                  jax_pre.nearest_indices(out_size, in_size))


@pytest.mark.parametrize("b,src,dst", [(2, 256, 64), (1, 1536, 416)])
def test_preprocess_and_k1_plain_bit_exact(b, src, dst):
    tiles = np.random.RandomState(src).randint(0, 256, (b, src, src, 3)).astype(np.uint8)
    want = np.asarray(jax_pre.preprocess_tiles(jnp.asarray(tiles), dst))
    got = port_pre.preprocess_tiles(torch.from_numpy(tiles), dst)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # K1 (plain version on the CPU) writes bf16: bit-exact to bf16(preprocess_tiles)
    want_bf16 = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    k1 = resize_normalize(torch.from_numpy(tiles), dst)
    assert k1.dtype == torch.bfloat16 and tuple(k1.shape) == (b, dst, dst, 3)
    np.testing.assert_array_equal(k1.float().numpy(), want_bf16)
    assert resize_normalize.launches == 0  # CPU tensors never launch the kernel


def test_k1_division_rule_is_exact_in_bf16():
    """The kernel divides (IEEE u8/255) where the reference multiplies by
    float32(1/255): 126 of the 256 f32 values differ by one ulp, none after
    rounding to bf16 — so the kernel is bit-exact to the plain version."""
    v = np.arange(256, dtype=np.float32)
    div = v / np.float32(255)
    mul = v * np.float32(port_pre.RECIP_255)
    assert int((div != mul).sum()) == 126
    as_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    assert torch.equal(as_bf16(div), as_bf16(mul))
    tiles = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1).repeat(1, 1, 1, 3)
    out = resize_normalize_plain(tiles, 16)
    assert torch.equal(out[..., 0].flatten(), as_bf16(div))


@pytest.mark.parametrize("bad", [
    torch.zeros(2, 8, 8, 3, dtype=torch.float32),
    torch.zeros(8, 8, 3, dtype=torch.uint8),
    torch.zeros(2, 8, 8, 4, dtype=torch.uint8),
])
def test_k1_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        resize_normalize(bad, 4)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("h,w", [(100, 160), (160, 100), (50, 50), (99, 100)])
def test_pad_to_square_matches_jax(h, w, batch, dtype):
    shape = (h, w, 3) if batch is None else (batch, h, w, 3)
    x = np.random.RandomState(h * w).randint(1, 256, shape).astype(dtype)
    want, want_pads = jax_pre.pad_to_square(jnp.asarray(x))
    got, pads = port_pre.pad_to_square(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pads == want_pads


def test_pad_to_square_pad_value_matches_jax():
    x = np.random.RandomState(5).rand(2, 99, 160, 3).astype(np.float32)
    want, want_pads = jax_pre.pad_to_square(jnp.asarray(x), pad_value=0.5)
    got, pads = port_pre.pad_to_square(torch.from_numpy(x), pad_value=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pads == want_pads == (30, 31, 0, 0)
    assert (got[:, :30] == 0.5).all() and (got[:, 129:] == 0.5).all()
