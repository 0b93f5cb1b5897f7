"""Tile preprocessing: nearest resize and scale to [0, 1].

Counterpart of the reference package's ``ops/preprocess.py:31-94``.  The
index rule is ``torch.nn.functional.interpolate(mode="nearest")``'s:
``src = floor(dst * in/out)``; the resize gathers uint8 values and the scale
runs after it, which equals scale-then-resize because nearest only gathers.

The f32 scale multiplies by ``float32(1/255)``: that is what the reference's
compiled ``x.astype(f32) / 255.0`` computes (XLA rewrites the division by a
constant into this product; it differs from IEEE ``x / 255`` in 126 of the
256 values, always by one f32 ulp).  Rounded to bf16 the two rules agree on
all 256 values, which is why the bf16 kernel K1
(:mod:`amyloid_yolo_tpu_torch.kernels.preprocess_kernel`) can divide and
still be bit-exact to this function.
"""

from __future__ import annotations

import numpy as np
import torch

RECIP_255 = float(np.float32(1.0 / 255.0))


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """F.interpolate(nearest) source index per output position."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int32)
    return np.minimum(idx, in_size - 1)


def resize_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-neighbour resize of an NHWC (or HWC) tensor to (size, size)."""
    h_axis, w_axis = x.dim() - 3, x.dim() - 2
    hi = torch.from_numpy(nearest_indices(size, x.shape[h_axis])).to(x.device)
    wi = torch.from_numpy(nearest_indices(size, x.shape[w_axis])).to(x.device)
    return x.index_select(h_axis, hi).index_select(w_axis, wi)


def preprocess_tiles(tiles_u8: torch.Tensor, model_size: int = 416) -> torch.Tensor:
    """uint8 NHWC square tiles → float32 NHWC model input in [0, 1]."""
    x = resize_nearest(tiles_u8, model_size)
    return x.to(torch.float32) * RECIP_255


def f32_from_bf16_input(x: torch.Tensor) -> torch.Tensor:
    """:func:`preprocess_tiles`'s float32 values from their bf16 rounding
    (K1's output), exactly: the 256 values ``bf16(u8 · f32(1/255))`` are
    distinct and each lies within 0.5/255 of ``u8/255``, so ``round(255·x)``
    gives back the pixel.  The int8 paths quantize this f32 input."""
    return torch.round(x.to(torch.float32) * 255.0) * RECIP_255


__all__ = ["nearest_indices", "resize_nearest", "preprocess_tiles",
           "f32_from_bf16_input", "RECIP_255"]
