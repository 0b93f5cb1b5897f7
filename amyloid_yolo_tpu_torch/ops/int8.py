"""int8 building blocks shared by the int8 executors and K3's plain version.

* :func:`int_mm` — exact int8 × int8 → int32 matrix product through
  ``torch._int_mm``.  On CUDA that call needs K and N to be multiples of 8
  and more than 16 rows; the operands are zero-padded to fit, which adds
  exact zeros to every sum.
* :func:`conv_int8` — an int8 NHWC convolution with an exact int32 result:
  one GEMM for a 1×1, one shifted GEMM a tap otherwise (nine for a 3×3,
  strided rows for stride 2; four for the space-to-depth 2×2, whose zero
  padding is one row and column before the map and none after), and one
  GEMM on an im2col matrix when the input has fewer than a multiple of 8
  channels (the RGB stem, K = 27 → 32).  int8 ``F.conv2d`` and
  ``F.unfold`` do not exist on CUDA.
* :func:`quant` — ``clip(round(y · r), ±127)`` with ``r = f32(1) / f32(s)``,
  the executors' rule.  The reference writes ``y / s`` with ``s`` a Python
  float its compiled program closes over; XLA's algebraic simplifier (a
  pass every backend runs) turns the division by a constant into a product
  with the constant's reciprocal, folded in float32 from the float32 scale.
  Folding ``1/s`` in double and rounding it instead flips int8 levels
  against ``jax.jit`` on some scales (55 of 200 random scales give another
  float32 factor), and so does true division, which is what eager JAX
  computes.  ``r`` is a float32 tensor on ``y``'s device
  (:func:`inverse_scales`).
* :func:`requant` — ``clip(round(y · f32(1/s)), ±127)`` with ``1/s`` taken in
  double, K3's rule: the reference kernel receives ``1.0 / s`` as a weakly
  typed Python float, which no pass refolds.
* :func:`maxpool_int8`, :func:`upsample_int8` — index arithmetic only, so
  they run on any device (int8 ``F.max_pool2d`` and ``F.interpolate`` are
  not available everywhere).

Rounding is half to even everywhere (``torch.round``, like ``jnp.round``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

QMAX = 127


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` (M, K) int8 @ ``w`` (N, K) int8 transposed → (M, N) int32, exact."""
    m, k = a.shape
    n = w.shape[0]
    pad_k, pad_n, pad_m = -k % 8, -n % 8, max(0, 17 - m)
    if pad_k:
        a, w = F.pad(a, (0, pad_k)), F.pad(w, (0, pad_k))
    if pad_n:
        w = F.pad(w, (0, 0, 0, pad_n))
    if pad_m:
        a = F.pad(a, (0, 0, 0, pad_m))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if pad_m or pad_n else out


def conv_int8(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1, pad=0
              ) -> torch.Tensor:
    """``xq`` (B, H, W, C) int8, ``wq`` (O, C, k, k) int8 → exact int32
    (B, Ho, Wo, O), zero padding: ``pad`` rows and columns on each side, or
    a pair ``(before, after)`` (top and left, bottom and right)."""
    b, h, w, c = xq.shape
    o, _, k, _ = wq.shape
    p0, p1 = (pad, pad) if isinstance(pad, int) else pad
    ho = (h + p0 + p1 - k) // stride + 1
    wo = (w + p0 + p1 - k) // stride + 1
    if k == 1 and stride == 1 and p0 == p1 == 0:
        return int_mm(xq.reshape(-1, c), wq.reshape(o, c)).reshape(b, h, w, o)
    xp = F.pad(xq, (0, 0, p0, p1, p0, p1)) if p0 or p1 else xq

    def tap(di: int, dj: int) -> torch.Tensor:
        return xp[:, di:di + stride * (ho - 1) + 1:stride,
                  dj:dj + stride * (wo - 1) + 1:stride].reshape(-1, c)

    if c % 8:
        cols = torch.cat([tap(di, dj) for di in range(k) for dj in range(k)], dim=1)
        acc = int_mm(cols, wq.permute(0, 2, 3, 1).reshape(o, k * k * c))
        return acc.reshape(b, ho, wo, o)
    taps = wq.permute(2, 3, 0, 1).reshape(k * k, o, c)
    acc = None
    for di in range(k):
        for dj in range(k):
            d = int_mm(tap(di, dj), taps[di * k + dj])
            acc = d if acc is None else acc.add_(d)
    return acc.reshape(b, ho, wo, o)


def inverse_scales(scales: Mapping[str, float], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """Each scale's reciprocal ``f32(1) / f32(s)`` (an IEEE float32
    division, as XLA folds it) as a 0-d float32 tensor on ``device``, from
    one copy."""
    inv = np.float32(1) / np.asarray(list(scales.values()), np.float32)
    values = torch.from_numpy(inv).to(device)
    return dict(zip(scales, values.unbind()))


def quant(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``clip(round(y · inv), ±127)`` as int8; ``inv`` from
    :func:`inverse_scales`."""
    return torch.clamp(torch.round(y * inv), -QMAX, QMAX).to(torch.int8)


def requant(y: torch.Tensor, s: float) -> torch.Tensor:
    """``clip(round(y · f32(1/s)), ±127)`` as int8: ``1/s`` in double, then
    rounded to float32, as the reference's weakly typed static is."""
    return torch.clamp(torch.round(y * (1.0 / s)), -QMAX, QMAX).to(torch.int8)


def maxpool_int8(xq: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Max pool of an NHWC int8 map with the float executor's padding rules:
    a kernel-2/stride-1 pool pads right and bottom with 0, any other pads
    ``(k-1)//2`` on each side with −128 (the reduction's init value)."""
    if kernel == 2 and stride == 1:
        xp = F.pad(xq, (0, 0, 0, 1, 0, 1), value=0)
    else:
        p = (kernel - 1) // 2
        xp = F.pad(xq, (0, 0, p, p, p, p), value=-128)
    ho = (xp.shape[1] - kernel) // stride + 1
    wo = (xp.shape[2] - kernel) // stride + 1
    out = None
    for di in range(kernel):
        for dj in range(kernel):
            v = xp[:, di:di + stride * (ho - 1) + 1:stride,
                   dj:dj + stride * (wo - 1) + 1:stride]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def upsample_int8(xq: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest upsampling of an NHWC map by an integer factor (a repeat)."""
    b, h, w, c = xq.shape
    return xq[:, :, None, :, None, :].expand(b, h, factor, w, factor, c).reshape(
        b, h * factor, w * factor, c)


__all__ = ["int_mm", "conv_int8", "inverse_scales", "quant", "requant",
           "maxpool_int8", "upsample_int8", "QMAX"]
