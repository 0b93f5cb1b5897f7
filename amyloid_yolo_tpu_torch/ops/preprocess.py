"""Tile preprocessing: nearest resize and scale to [0, 1], square padding,
and the 256² crops of the CAA filter.

Counterpart of the reference package's ``ops/preprocess.py``.  The
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

from typing import Tuple

import numpy as np
import torch

RECIP_255 = float(np.float32(1.0 / 255.0))


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """F.interpolate(nearest) source index per output position."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int32)
    return np.minimum(idx, in_size - 1)


def resize_nearest(x: torch.Tensor, size: int, *, layout: str = "nhwc") -> torch.Tensor:
    """Nearest-neighbour resize to (size, size) of an NHWC (or HWC) tensor,
    or with ``layout="planar"`` of a (B, C, H, W) (or (C, H, W)) one."""
    if layout == "planar":
        h_axis, w_axis = x.dim() - 2, x.dim() - 1
    else:
        h_axis, w_axis = x.dim() - 3, x.dim() - 2
    hi = torch.from_numpy(nearest_indices(size, x.shape[h_axis])).to(x.device)
    wi = torch.from_numpy(nearest_indices(size, x.shape[w_axis])).to(x.device)
    return x.index_select(h_axis, hi).index_select(w_axis, wi)


def preprocess_tiles(tiles_u8: torch.Tensor, model_size: int = 416, *,
                     layout: str = "nhwc") -> torch.Tensor:
    """uint8 NHWC square tiles → float32 model input in [0, 1]: NHWC, or
    with ``layout="planar"`` contiguous (B, C, H, W), the tiles permuted
    once while they are uint8 (the reference's planar train step)."""
    if layout == "planar":
        tiles_u8 = tiles_u8.permute(0, 3, 1, 2).contiguous()
    x = resize_nearest(tiles_u8, model_size, layout=layout)
    return x.to(torch.float32) * RECIP_255


def f32_from_bf16_input(x: torch.Tensor) -> torch.Tensor:
    """:func:`preprocess_tiles`'s float32 values from their bf16 rounding
    (K1's output), exactly: the 256 values ``bf16(u8 · f32(1/255))`` are
    distinct and each lies within 0.5/255 of ``u8/255``, so ``round(255·x)``
    gives back the pixel.  The int8 paths quantize this f32 input."""
    return torch.round(x.to(torch.float32) * 255.0) * RECIP_255


def pad_to_square(x: torch.Tensor, pad_value: float = 0.0
                  ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """Centre-pad an HWC (or NHWC) tensor to a square on its own device,
    any dtype; returns ``(img, (top, bottom, left, right))``, the reference
    package's order, with the odd pixel below or to the right.
    :func:`pad_amounts` gives the reference's (left, right, top, bottom),
    and :func:`~amyloid_yolo_tpu_torch.io.datasets.pad_to_square_np` (the
    reader's uint8 host path) returns its pads in that order too."""
    h, w = x.shape[-3], x.shape[-2]
    diff = abs(h - w)
    p1, p2 = diff // 2, diff - diff // 2
    pads = (p1, p2, 0, 0) if h <= w else (0, 0, p1, p2)
    side = max(h, w)
    out = x.new_full((*x.shape[:-3], side, side, x.shape[-1]), pad_value)
    out[..., pads[0]:pads[0] + h, pads[2]:pads[2] + w, :] = x
    return out, pads


def pad_amounts(h: int, w: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) padding of the reference's ``pad_to_square``
    (``utils/datasets.py:26-28``): the odd pixel goes right or below."""
    diff = abs(h - w)
    p1, p2 = diff // 2, diff - diff // 2
    return (0, 0, p1, p2) if h <= w else (p1, p2, 0, 0)


def crop256_window(bbox_xywh) -> Tuple[int, int]:
    """Top-left (x0, y0) of the 256² crop centred on a box, clamped to a
    1536² tile: the closed form of the reference's ``get256Img``
    (``core.py:109-159``)."""
    x, y, w, h = bbox_xywh
    cx = int(x + (w / 2))
    cy = int(y + (h / 2))
    x0 = min(max(cx - 128, 0), 1536 - 256)
    y0 = min(max(cy - 128, 0), 1536 - 256)
    return x0, y0


def crop256(img: np.ndarray, bbox_xywh) -> np.ndarray:
    """Host 256² crop (HWC) of ``get256Img``."""
    x0, y0 = crop256_window(bbox_xywh)
    return img[y0:y0 + 256, x0:x0 + 256]


def batched_crop256(tile_u8: torch.Tensor, origins: torch.Tensor) -> torch.Tensor:
    """K 256² crops of one HWC tile in one gather: ``origins`` (K, 2) rows
    (x0, y0) → (K, 256, 256, C).  Starts follow the reference's
    ``dynamic_slice``: a negative start counts from the end, then each is
    clamped so the crop lies in the tile."""
    h, w = tile_u8.shape[0], tile_u8.shape[1]
    origins = origins.to(tile_u8.device, torch.long)
    x0, y0 = origins[:, 0], origins[:, 1]
    x0 = torch.where(x0 < 0, x0 + w, x0).clamp(0, w - 256)
    y0 = torch.where(y0 < 0, y0 + h, y0).clamp(0, h - 256)
    r = torch.arange(256, device=tile_u8.device)
    rows = (y0[:, None] + r)[:, :, None]   # (K, 256, 1)
    cols = (x0[:, None] + r)[:, None, :]   # (K, 1, 256)
    return tile_u8[rows, cols]


def normalize_crops(crops_u8: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize(mean, std) of the CAA classifier (``core.py:50``,
    ``:435``): x/255, then per channel (x - mean)/std; NHWC in and out."""
    x = crops_u8.to(torch.float32) / 255.0
    return (x - mean) / std


__all__ = ["nearest_indices", "resize_nearest", "preprocess_tiles",
           "f32_from_bf16_input", "RECIP_255", "pad_to_square", "pad_amounts", "crop256_window",
           "crop256", "batched_crop256", "normalize_crops"]
