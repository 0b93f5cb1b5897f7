"""K3: one quantized Darknet residual unit, fused into one kernel, int8 → int8.

    h = q(leaky(conv1x1(x)·a1 + b1), s1)          masked to 0 outside the image
    y = q(leaky(conv3x3(h)·a2 + b2) + x·sx, s_out)
    q(v, s) = clip(round_half_even(v · f32(1/s)), ±127)

Replaces the reference package's Pallas kernel
``pallas/int8_block.py:fused_residual_block_int8`` (``pl.pallas_call`` at
``:150``) and its packing ``pack_int8_block`` (``:109``), with the same
contract: int8 × int8 → int32 products, exact; a float32 epilogue with the
multiply and the add rounded separately; ``a1 = ws1·sx`` and ``a2 = ws2·s1``
premultiplied by the caller; ``1/s`` computed in double and rounded to
float32; leaky as ``where(v >= 0, v, v·f32(0.1))``.  Its oracle is
``reference_block_int8`` (``:181``), which :func:`fused_residual_block_int8_plain`
mirrors.

K3 computes a different function from a residual unit of
``apply_folded_int8_full``: the executor requantizes the 3×3 output at its
own scale before the shortcut add, divides by ``s`` instead of multiplying
by ``1/s``, and accumulates in bf16 by default.  So the port's ``Detector``
does not call it; K3's path is :func:`pack_model_int8_units` (the units of a
calibrated ``int8_full`` model) run through the kernel, as the reference's
``tools/bench_int8_block.py`` runs it.

The CUDA source is ``csrc/int8_block.cu``, K2's design in int8: a block
owns one tile, (image, strip of output rows, range of output columns, range
of output channels); it computes the 1×1 of the tile's in-image pixels and
their one-pixel halo into shared memory as int8 (one zero pixel stands for
the halo outside the image), then the nine 3×3 taps from there, both on the
tensor cores (``mma.sync`` m16n8k32 s8·s8 → s32, fragments loaded with
``ldmatrix``).  Weight k-slices, and in the 1×1 the ``x`` pixels, stream
through a ring of shared-memory stages fed by ``cp.async``.

The tiling comes from K2's planner (``conv_block.plan_launch``) with
:data:`K3`, this kernel's description: int8 elements, its own
:data:`COST_MODEL`, fitted to the H100 times of every tiling the plan
weighs in ``PLAN_TIMES`` (``bench_k2.py --plans k3``, then ``--fit k3``).

Bound on an H100, per launch: ``max(B·20·H·W·C·C/2 / 1979 TOP/s,
(B·2·H·W·C + 10·C·C/2) B / 3.35 TB/s)`` — bytes for the 208² × 64 unit,
operations for the others.

:func:`fused_residual_block_int8` launches the kernel for a CUDA tensor
(int8, C a multiple of 64) and counts the launch in
``fused_residual_block_int8.launches``; for a CPU tensor it runs the plain
version; anything else raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graphspec import GraphSpec
from ..ops.int8 import conv_int8, int_mm, requant
from . import _build
from .bias_leaky import leaky_where
from .conv_block import KernelDesc, Plan, fits_in_smem, plan_launch, sm_count, smem_bytes

# The planner's cost model for this kernel (see conv_block.COST_MODEL):
# (SM int8 op/s with 32-channel warps, with 64-channel warps, s per k-step,
# s per tile), fitted by conv_block.fit_cost_model to the H100 times in
# PLAN_TIMES of every tiling the plan weighs at the five stages of
# YOLOv3-416, B=8 and 32.
COST_MODEL = (4.343e12, 4.496e12, 0.7281e-6, 1.727e-6)
PLAN_TIMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "int8_block_plan_times.json")
# int8 elements; 16 bytes of padding per hidden pixel; 64-channel 1x1
# slices; 3x3 slices of 128 channels, or C/2 below that
K3 = KernelDesc("fused_residual_block_int8", 1, 16, 64, (128, 64, 32), COST_MODEL,
                PLAN_TIMES)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Int8Unit(NamedTuple):
    """One fusible unit of an ``int8_full`` model, ready for K3."""

    pack: Tuple[torch.Tensor, ...]  # (w1t, a1, b1, w2t, a2, b2), a* premultiplied
    sx: float
    s1: float
    s_out: float


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_block")
    if lib.amyolo_fused_residual_block_int8.argtypes is None:
        lib.amyolo_fused_residual_block_int8.argtypes = (
            [_P] * 8 + [_I] * 11 + [_F] * 3 + [_P])
        lib.amyolo_fused_residual_block_int8.restype = ctypes.c_int
        lib.amyolo_int8_block_smem_bytes.argtypes = [_I] * 7
        lib.amyolo_int8_block_smem_bytes.restype = ctypes.c_int
        lib.amyolo_int8_block_blocks_per_sm.argtypes = [_I] * 4
        lib.amyolo_int8_block_blocks_per_sm.restype = ctypes.c_int
    return lib


def pack_int8_block(w1q: torch.Tensor, ws1: torch.Tensor, b1: torch.Tensor,
                    w2q: torch.Tensor, ws2: torch.Tensor, b2: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """Per-conv int8 weights (OIHW), scales and biases → the kernel's layouts.

    ``w1q`` (C2, C, 1, 1) → ``w1t`` (C2, C); ``w2q`` (C, C2, 3, 3) → ``w2t``
    (9, C, C2), tap ``3·di + dj``; the input channel contiguous in both.
    Scales and biases become contiguous float32.  The caller premultiplies
    the scales: ``a1 = ws1·sx``, ``a2 = ws2·s1``.
    """
    c2, c = w1q.shape[0], w1q.shape[1]
    f32 = torch.float32
    return (w1q.reshape(c2, c).to(torch.int8).contiguous(),
            ws1.to(f32).contiguous(), b1.to(f32).contiguous(),
            w2q.permute(2, 3, 0, 1).reshape(9, c, c2).to(torch.int8).contiguous(),
            ws2.to(f32).contiguous(), b2.to(f32).contiguous())


def fused_residual_block_int8_plain(xq: torch.Tensor, w1t: torch.Tensor,
                                    a1: torch.Tensor, b1: torch.Tensor,
                                    w2t: torch.Tensor, a2: torch.Tensor,
                                    b2: torch.Tensor, *, sx: float, s1: float,
                                    s_out: float) -> torch.Tensor:
    """Plain PyTorch K3 on NHWC int8 ``xq``: exact int32 products through
    ``torch._int_mm`` (the 3×3 as nine shifted GEMMs over the zero-padded
    hidden map), then the kernel's float32 epilogue."""
    b, h, w, c = xq.shape
    c2 = w1t.shape[0]
    f32 = torch.float32
    acc1 = int_mm(xq.reshape(-1, c), w1t)
    hq = requant(leaky_where(acc1.to(f32) * a1 + b1), s1).reshape(b, h, w, c2)
    w2 = w2t.reshape(3, 3, c, c2).permute(2, 3, 0, 1)  # OIHW view
    acc2 = conv_int8(hq, w2, 1, 1).reshape(-1, c)
    y = leaky_where(acc2.to(f32) * a2 + b2) + xq.reshape(-1, c).to(f32) * sx
    return requant(y, s_out).reshape(b, h, w, c)


def fused_residual_block_int8(xq: torch.Tensor, w1t: torch.Tensor, a1: torch.Tensor,
                              b1: torch.Tensor, w2t: torch.Tensor, a2: torch.Tensor,
                              b2: torch.Tensor, *, sx: float, s1: float, s_out: float,
                              strip: Optional[int] = None,
                              plan: Optional[Plan] = None) -> torch.Tensor:
    """(B, H, W, C) int8 → (B, H, W, C) int8; packed weights from
    :func:`pack_int8_block`.  ``strip`` (output rows per block), if given,
    must divide H.  On the card, ``plan`` is the tiling, by default
    ``plan_launch``'s for :data:`K3`, restricted to the caller's strip; a
    plan that does not fit raises."""
    if xq.dim() != 4:
        raise ValueError(f"fused_residual_block_int8 takes NHWC xq, got {tuple(xq.shape)}")
    b, h, w, c = xq.shape
    c2 = c // 2
    if (tuple(w1t.shape) != (c2, c) or tuple(w2t.shape) != (9, c, c2)
            or tuple(a1.shape) != (c2,) or tuple(b1.shape) != (c2,)
            or tuple(a2.shape) != (c,) or tuple(b2.shape) != (c,)):
        raise ValueError("fused_residual_block_int8: packed weights do not match "
                         f"xq's {c} channels")
    if strip is not None and h % strip:
        raise ValueError(f"strip {strip} must divide H {h}")
    if strip is not None and plan is not None and plan.strip != strip:
        raise ValueError(f"plan {tuple(plan)} does not have strip {strip}")
    if xq.device.type == "cpu":
        return fused_residual_block_int8_plain(xq, w1t, a1, b1, w2t, a2, b2,
                                               sx=sx, s1=s1, s_out=s_out)
    if xq.device.type != "cuda":
        raise ValueError(f"fused_residual_block_int8: unsupported device {xq.device}")
    if xq.dtype != torch.int8 or w1t.dtype != torch.int8 or w2t.dtype != torch.int8:
        raise ValueError("fused_residual_block_int8 takes int8 xq and weights "
                         f"(got {xq.dtype}, {w1t.dtype}, {w2t.dtype})")
    if any(t.dtype != torch.float32 for t in (a1, b1, a2, b2)):
        raise ValueError("fused_residual_block_int8: scales and biases must be float32")
    if c % 64 != 0:
        raise ValueError(f"fused_residual_block_int8 on CUDA needs C % 64 == 0, got C={c}")
    tensors = (xq, w1t, a1, b1, w2t, a2, b2)
    if any(t.device != xq.device for t in tensors):
        raise ValueError("fused_residual_block_int8: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_residual_block_int8: tensors must be contiguous (xq NHWC)")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_residual_block_int8: tensors must be 16-byte aligned")
    if plan is None:
        plan = plan_launch(b, h, w, c, sm_count(xq.device), K3, strip)
    elif not fits_in_smem(h, w, c, plan, K3):
        raise ValueError(f"fused_residual_block_int8: plan {tuple(plan)} does not fit "
                         "in shared memory")
    y = torch.empty_like(xq)
    lib = _lib()
    f32 = np.float32
    with torch.cuda.device(xq.device):
        err = lib.amyolo_fused_residual_block_int8(
            xq.data_ptr(), w1t.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            w2t.data_ptr(), a2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            b, h, w, c, c2, plan.strip, plan.col_tile, plan.oc_tile, plan.warp_n,
            plan.block_n, smem_bytes(h, w, c, plan, K3),
            float(f32(sx)), float(f32(1.0 / s1)), float(f32(1.0 / s_out)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_residual_block_int8 kernel launch")
    fused_residual_block_int8.launches += 1
    return y


fused_residual_block_int8.launches = 0


def pack_model_int8_units(qparams: Mapping[str, Mapping[str, torch.Tensor]],
                          act_scales: Mapping[str, float], spec: GraphSpec,
                          device: Optional[torch.device] = None) -> Dict[int, Int8Unit]:
    """K3 units of a calibrated ``int8_full`` model: for each fusible
    residual unit ``i`` whose two convs are quantized, the pack of conv
    ``i`` and conv ``i+1`` with ``sx = act_scales[str(i-1)]``, ``s1 =
    act_scales[str(i)]`` and ``s_out = act_scales[str(i+2)]`` (the unit's
    input, hidden and shortcut scales), on ``device``."""
    from ..models.darknet import fusible_residual_blocks  # darknet imports kernels

    units: Dict[int, Int8Unit] = {}
    for i in fusible_residual_blocks(spec):
        if f"conv_{i}" not in qparams or f"conv_{i + 1}" not in qparams:
            continue
        q1, q2 = qparams[f"conv_{i}"], qparams[f"conv_{i + 1}"]
        sx, s1, s_out = (float(act_scales[str(k)]) for k in (i - 1, i, i + 2))
        w1t, ws1, b1, w2t, ws2, b2 = pack_int8_block(
            q1["wq"].cpu(), q1["ws"].cpu(), q1["b"].cpu(),
            q2["wq"].cpu(), q2["ws"].cpu(), q2["b"].cpu())
        pack = (w1t, ws1 * sx, b1, w2t, ws2 * s1, b2)
        units[i] = Int8Unit(tuple(t.to(device) for t in pack) if device else pack,
                            sx, s1, s_out)
    return units


def c_smem_bytes(h: int, w: int, c: int, plan: Plan) -> int:
    """The C side's shared-memory formula (needs the built library)."""
    return _lib().amyolo_int8_block_smem_bytes(h, w, c // 2, plan.strip, plan.col_tile,
                                               plan.warp_n, plan.block_n)


def c_blocks_per_sm(c: int, plan: Plan, smem: int) -> int:
    """Resident blocks per SM from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    n = _lib().amyolo_int8_block_blocks_per_sm(plan.warp_n, plan.block_n, c // 2, smem)
    if n < 0:
        _build.check(-n, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return n


__all__ = ["fused_residual_block_int8", "fused_residual_block_int8_plain",
           "pack_int8_block", "pack_model_int8_units", "Int8Unit", "K3", "COST_MODEL",
           "PLAN_TIMES", "c_smem_bytes", "c_blocks_per_sm"]
