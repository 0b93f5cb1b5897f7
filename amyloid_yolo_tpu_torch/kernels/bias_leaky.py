"""The epilogue of a library convolution: bias and leaky ReLU (or Mish), in
place.

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

:func:`bias_mish` is the same pass for YOLOv4's Mish convs (kernel
``bias_mish_kernel`` in the same source, behind the same entry point,
launches in ``bias_mish.launches``): the bias added in the tensor's dtype, then Mish in
float32 on that sum, rounded once.  Its plain version
:func:`bias_mish_plain` takes ``F.mish``; the kernel takes ``t·n/(n+2)``
with ``n = eᵗ(eᵗ+2)`` (one exp, one division), and the two agree to one
bf16 ulp.  The 72 Mish convs of YOLOv4 write 94.8 M elements an image at
608: at B=64, 24.27 GB read and written in bf16, 7.25 ms at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .conv_block import LEAKY_SLOPE

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("bias_leaky")
    fn = lib.amyolo_bias_act
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


def mish_wide(v: torch.Tensor) -> torch.Tensor:
    """Mish of ``v`` computed in at least float32 and rounded once to
    ``v``'s dtype (``F.mish``: ``x·tanh(softplus(x))``, ``x`` itself where
    softplus's threshold of 20 takes over)."""
    return F.mish(v.to(torch.promote_types(v.dtype, torch.float32))).to(v.dtype)


def bias_mish_plain(out: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: the NCHW ``out`` plus ``b`` in ``out``'s dtype, then
    :func:`mish_wide` of that sum."""
    return mish_wide(out + b.to(out.dtype)[None, :, None, None])


_SLOPES = {dt: float(torch.tensor(LEAKY_SLOPE, dtype=dt)) for dt in (torch.bfloat16,
                                                                      torch.float32)}


_LINEAR, _LEAKY, _MISH = 0, 1, 2   # amyolo_bias_act's activations


def _launch(out: torch.Tensor, b: torch.Tensor, act: int, what: str) -> None:
    """Checks ``out`` and ``b`` for the kernels and runs activation ``act``
    over ``out`` in place on its card."""
    if out.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {out.device}")
    if out.dtype not in _SLOPES:
        raise ValueError(f"{what} takes bf16 or float32, got {out.dtype}")
    if out.requires_grad:
        raise ValueError(f"{what} writes in place and has no backward: out requires grad")
    if out.dim() != 4 or b.shape != (out.shape[1],):
        raise ValueError(f"{what} takes (B, C, H, W) and (C,), got {tuple(out.shape)} "
                         f"and {tuple(b.shape)}")
    if out.is_contiguous(memory_format=torch.channels_last):
        inner = 1
    elif out.is_contiguous():
        inner = out.shape[2] * out.shape[3]
    else:
        raise ValueError(f"{what}: out must be channels_last- or NCHW-contiguous")
    bias = b.to(out.device, out.dtype).contiguous()
    with torch.cuda.device(out.device):
        err = _lib().amyolo_bias_act(
            out.data_ptr(), bias.data_ptr(), out.numel(), out.shape[1], inner,
            int(out.dtype == torch.bfloat16), act, _SLOPES[out.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"{what} kernel launch")


def bias_leaky(out: torch.Tensor, b: torch.Tensor, leaky: bool) -> torch.Tensor:
    """:func:`bias_leaky_plain` of the NCHW conv output ``out`` (B, C, H,
    W) and its bias ``b`` (C,): on the card written into ``out``, which is
    returned.  ``out`` is bf16 or float32, channels_last- or
    NCHW-contiguous, and does not require grad (the kernel has no
    backward)."""
    if out.device.type == "cpu":
        return bias_leaky_plain(out, b, leaky)
    _launch(out, b, _LEAKY if leaky else _LINEAR, "bias_leaky")
    bias_leaky.launches += 1
    return out


def bias_mish(out: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`bias_mish_plain` of ``out`` and ``b``, taking what
    :func:`bias_leaky` takes: on the card written into ``out`` (to one bf16
    ulp of the plain version), on the CPU the plain version."""
    if out.device.type == "cpu":
        return bias_mish_plain(out, b)
    _launch(out, b, _MISH, "bias_mish")
    bias_mish.launches += 1
    return out


bias_leaky.launches = 0
bias_mish.launches = 0

__all__ = ["bias_leaky", "bias_leaky_plain", "bias_mish", "bias_mish_plain", "leaky_where",
           "mish_wide"]
