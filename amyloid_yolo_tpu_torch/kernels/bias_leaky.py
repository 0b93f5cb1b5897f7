"""The epilogue of a library convolution: bias and leaky ReLU, in place.

Replaces no Pallas kernel: on the TPU, XLA fused the bias and the leaky
into the convolution.  On the card cuDNN runs the conv, and its fused
conv-bias-activation has no leaky ReLU, so :func:`bias_leaky` adds the
bias and applies the activation in one pass over the conv's output, in
place of the four PyTorch elementwise passes of :func:`bias_leaky_plain`
(the add, the compare, the multiply and the where).  The CUDA source is
``csrc/bias_leaky.cu``.

Bound on an H100: memory (0.25 FLOP a byte).  The 29 convs of YOLOv3
outside the residual units write 16,558,113 elements an image at 416: at
B=64 one read and one write of them in bf16 is 4.24 GB, 1.27 ms at
3.35 TB/s, where the four passes moved 19.0 GB.  The kernel reads and
writes 16 bytes a thread, over one wave of blocks.

Its arithmetic is the plain version's, rounding point for rounding point,
so the two agree bit for bit (``-0.0``, infinities and NaN included).

:func:`bias_leaky` launches the kernel for a CUDA tensor and counts the
launch in ``bias_leaky.launches``; for a CPU tensor it returns the plain
version (a new tensor); any other input raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .conv_block import LEAKY_SLOPE

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("bias_leaky")
    fn = lib.amyolo_bias_leaky
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def leaky_where(v: torch.Tensor) -> torch.Tensor:
    # the slope is rounded to v's dtype first, as jnp's weakly typed 0.1 is
    return torch.where(v >= 0, v, v * torch.tensor(LEAKY_SLOPE, dtype=v.dtype))


def bias_leaky_plain(out: torch.Tensor, b: torch.Tensor, leaky: bool) -> torch.Tensor:
    """Plain PyTorch: the NCHW ``out`` plus ``b`` in ``out``'s dtype, then
    :func:`leaky_where` where ``leaky`` (a linear conv stops at the sum)."""
    y = out + b.to(out.dtype)[None, :, None, None]
    return leaky_where(y) if leaky else y


_SLOPES = {dt: float(torch.tensor(LEAKY_SLOPE, dtype=dt)) for dt in (torch.bfloat16,
                                                                      torch.float32)}


def bias_leaky(out: torch.Tensor, b: torch.Tensor, leaky: bool) -> torch.Tensor:
    """:func:`bias_leaky_plain` of the NCHW conv output ``out`` (B, C, H,
    W) and its bias ``b`` (C,): on the card written into ``out``, which is
    returned.  ``out`` is bf16 or float32, channels_last- or
    NCHW-contiguous, and does not require grad (the kernel has no
    backward)."""
    if out.device.type == "cpu":
        return bias_leaky_plain(out, b, leaky)
    if out.device.type != "cuda":
        raise ValueError(f"bias_leaky: unsupported device {out.device}")
    if out.dtype not in _SLOPES:
        raise ValueError(f"bias_leaky takes bf16 or float32, got {out.dtype}")
    if out.requires_grad:
        raise ValueError("bias_leaky writes in place and has no backward: out requires grad")
    if out.dim() != 4 or b.shape != (out.shape[1],):
        raise ValueError(f"bias_leaky takes (B, C, H, W) and (C,), got {tuple(out.shape)} "
                         f"and {tuple(b.shape)}")
    if out.is_contiguous(memory_format=torch.channels_last):
        inner = 1
    elif out.is_contiguous():
        inner = out.shape[2] * out.shape[3]
    else:
        raise ValueError("bias_leaky: out must be channels_last- or NCHW-contiguous")
    bias = b.to(out.device, out.dtype).contiguous()
    with torch.cuda.device(out.device):
        err = _lib().amyolo_bias_leaky(
            out.data_ptr(), bias.data_ptr(), out.numel(), out.shape[1], inner,
            int(out.dtype == torch.bfloat16), int(leaky), _SLOPES[out.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bias_leaky kernel launch")
    bias_leaky.launches += 1
    return out


bias_leaky.launches = 0

__all__ = ["bias_leaky", "bias_leaky_plain", "leaky_where"]
