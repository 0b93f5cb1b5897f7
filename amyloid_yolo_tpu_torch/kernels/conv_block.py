"""K2: one BN-folded Darknet residual unit, fused into one kernel.

    y = x + leaky(conv3x3(leaky(conv1x1(x) + b1)) + b2),  slope 0.1

Replaces the reference package's Pallas kernel
``pallas/conv_block.py:fused_residual_block`` (``pl.pallas_call`` at
``:107``) and its packing ``pack_block_weights`` (``:82``), with the same
contract: f32 accumulation and f32 biases, the hidden map cast to
``x.dtype`` between the convs and zero-padded, the residual add in f32 and
then the cast.

The CUDA source is ``csrc/conv_block.cu``: a block owns (image, strip of
output rows, tile of output channels), computes the 1×1 for its strip plus a
one-row halo into shared memory, then the 3×3 from there, both on the
tensor cores (``mma.sync`` bf16 → f32).  Output-channel tiles of a 512- or
1024-channel unit each recompute the strip's 1×1 (1.3× and 1.7× the unit's
FLOPs).

Bound on an H100, per launch: ``max(B·20·H·W·C·C/2 / 989 TFLOP/s,
(B·4·H·W·C + 20·C·C/2) B / 3.35 TB/s)`` — compute for the units of 128
channels and more, memory for the 208² × 64 unit.

:func:`fused_residual_block` launches the kernel for a CUDA tensor (bf16,
C a multiple of 64) and counts the launch in
``fused_residual_block.launches``; for a CPU tensor it runs
:func:`fused_residual_block_plain` in any float dtype; anything else
raises.  f32 on the card is not supported by the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

LEAKY_SLOPE = 0.1
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on Hopper
MAX_STRIP = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_block")
    if lib.amyolo_fused_residual_block.argtypes is None:
        lib.amyolo_fused_residual_block.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        lib.amyolo_fused_residual_block.restype = ctypes.c_int
        lib.amyolo_conv_block_smem_bytes.argtypes = [_I, _I, _I]
        lib.amyolo_conv_block_smem_bytes.restype = ctypes.c_int
    return lib


def pack_block_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, ...]:
    """Folded OIHW conv params → the kernel's layouts.

    ``w1`` (C2, C, 1, 1) → ``w1t`` (C2, C); ``w2`` (C, C2, 3, 3) → ``w2t``
    (9, C, C2), tap ``3·di + dj``; both in ``dtype`` with the input channel
    contiguous.  Biases stay f32.
    """
    c2, c = w1.shape[0], w1.shape[1]
    w1t = w1.reshape(c2, c).to(dtype).contiguous()
    w2t = w2.permute(2, 3, 0, 1).reshape(9, c, c2).to(dtype).contiguous()
    return (w1t, b1.to(torch.float32).contiguous(),
            w2t, b2.to(torch.float32).contiguous())


def _leaky(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, v * LEAKY_SLOPE)


def fused_residual_block_plain(x: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor,
                               w2t: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2 on NHWC ``x``: every product in f32 (x and the
    weights upcast), the hidden map rounded to ``x.dtype`` at the same point
    as the kernel.  On the card, f32 convolutions must run with TF32 off."""
    f32 = torch.float32
    c2, c = w1t.shape
    xf = x.to(f32)
    h = _leaky(xf @ w1t.to(f32).t() + b1.to(f32)).to(x.dtype).to(f32)
    w2 = w2t.to(f32).reshape(3, 3, c, c2).permute(2, 3, 0, 1)
    acc = F.conv2d(h.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    return (xf + _leaky(acc + b2.to(f32))).to(x.dtype)


def pick_strip(h: int, fits) -> int:
    """Output rows per block: at most ``MAX_STRIP``, balanced over ``h``,
    and the largest for which ``fits(strip)`` (shared memory) holds; 0 if
    none does."""
    n_strips = -(-h // MAX_STRIP)
    strip = -(-h // n_strips)
    while strip > 0 and not fits(strip):
        strip -= 1
    return strip


def launch_config(h: int, w: int, c: int) -> Tuple[int, int]:
    """``(strip, oc_tile)`` for a (H, W, C) unit: strips from
    :func:`pick_strip`; output-channel tiles of 128 above 128 channels."""
    lib = _lib()
    strip = pick_strip(h, lambda s: lib.amyolo_conv_block_smem_bytes(w, c // 2, s)
                       <= MAX_SMEM_BYTES)
    if strip == 0:
        raise ValueError(f"fused_residual_block: W={w}, C={c} does not fit in shared memory")
    return strip, min(c, 128)


def fused_residual_block(x: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor,
                         w2t: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, C); packed weights from
    :func:`pack_block_weights`."""
    if x.dim() != 4:
        raise ValueError(f"fused_residual_block takes NHWC x, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    c2 = c // 2
    if (tuple(w1t.shape) != (c2, c) or tuple(w2t.shape) != (9, c, c2)
            or tuple(b1.shape) != (c2,) or tuple(b2.shape) != (c,)):
        raise ValueError("fused_residual_block: packed weights do not match x's "
                         f"{c} channels")
    if x.device.type == "cpu":
        return fused_residual_block_plain(x, w1t, b1, w2t, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_block: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or w1t.dtype != torch.bfloat16 or w2t.dtype != torch.bfloat16:
        raise ValueError("fused_residual_block on CUDA takes bf16 x and weights "
                         f"(got {x.dtype}, {w1t.dtype}, {w2t.dtype}); f32 runs "
                         "only through the plain version on the CPU")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError("fused_residual_block: biases must be float32")
    if c % 64 != 0:
        raise ValueError(f"fused_residual_block on CUDA needs C % 64 == 0, got C={c}")
    tensors = (x, w1t, b1, w2t, b2)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_residual_block: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_residual_block: tensors must be contiguous (x NHWC)")
    strip, oc_tile = launch_config(h, w, c)
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.amyolo_fused_residual_block(
            x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), y.data_ptr(), b, h, w, c, c2, strip, oc_tile,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_residual_block kernel launch")
    fused_residual_block.launches += 1
    return y


fused_residual_block.launches = 0

__all__ = ["fused_residual_block", "fused_residual_block_plain",
           "pack_block_weights", "launch_config", "pick_strip", "LEAKY_SLOPE"]
