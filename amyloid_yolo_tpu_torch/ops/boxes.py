"""Box coordinate and IoU primitives (reference package ``ops/boxes.py``).

:func:`bbox_iou` keeps the detection-ops convention of the reference
(``utils/utils.py:202-232``): **+1 pixel** on widths/heights and a 1e-16
epsilon in the denominator.
"""

from __future__ import annotations

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (x1, y1, x2, y2); parity ``utils/utils.py:53-59``."""
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Elementwise xyxy IoU with the +1-pixel area convention; broadcasts
    over leading dims."""
    ix1 = torch.maximum(box1[..., 0], box2[..., 0])
    iy1 = torch.maximum(box1[..., 1], box2[..., 1])
    ix2 = torch.minimum(box1[..., 2], box2[..., 2])
    iy2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (ix2 - ix1 + 1).clamp(min=0) * (iy2 - iy1 + 1).clamp(min=0)
    a1 = (box1[..., 2] - box1[..., 0] + 1) * (box1[..., 3] - box1[..., 1] + 1)
    a2 = (box2[..., 2] - box2[..., 0] + 1) * (box2[..., 3] - box2[..., 1] + 1)
    return inter / (a1 + a2 - inter + 1e-16)


def rescale_boxes(boxes: torch.Tensor, current_dim: int, orig_h: int,
                  orig_w: int) -> torch.Tensor:
    """Undo the square letterbox for fixed-size outputs (B, K, ≥4); the
    batched counterpart of the reference's ``rescale_boxes``
    (``utils/utils.py:36-50``), including its ``// 2`` floor on the pad."""
    pad_x = max(orig_h - orig_w, 0) * (current_dim / max(orig_h, orig_w))
    pad_y = max(orig_w - orig_h, 0) * (current_dim / max(orig_h, orig_w))
    unpad_h = current_dim - pad_y
    unpad_w = current_dim - pad_x
    sx = orig_w / unpad_w
    sy = orig_h / unpad_h
    px = pad_x // 2
    py = pad_y // 2
    x1 = (boxes[..., 0] - px) * sx
    y1 = (boxes[..., 1] - py) * sy
    x2 = (boxes[..., 2] - px) * sx
    y2 = (boxes[..., 3] - py) * sy
    return torch.cat([torch.stack([x1, y1, x2, y2], dim=-1), boxes[..., 4:]], dim=-1)


def rescale_from_tile_frame(dets: np.ndarray, tile_size: int,
                            original_shape) -> np.ndarray:
    """Map host detections from the square tile frame back to an image's
    own pixels.

    :class:`~amyloid_yolo_tpu_torch.io.datasets.ImageFolder` frames a
    non-square or undersized tile (a WSI border) by centre-padding it to
    ``side = max(h, w)`` and nearest-resizing that square to ``tile_size``.
    The inverse scales by ``side / tile_size`` and subtracts the centre pads.
    Standard ``(tile_size, tile_size)`` tiles pass through unchanged.
    """
    h, w = int(original_shape[0]), int(original_shape[1])
    if (h, w) == (tile_size, tile_size):
        return np.asarray(dets)
    side = max(h, w)
    p1 = abs(h - w) // 2
    # h < w: vertical pad (top = p1); w < h: horizontal pad (left = p1)
    pad_l, pad_t = (0, p1) if h < w else (p1, 0) if w < h else (0, 0)
    s = side / float(tile_size)
    out = np.array(dets, np.float32, copy=True)
    out[:, [0, 2]] = out[:, [0, 2]] * s - pad_l
    out[:, [1, 3]] = out[:, [1, 3]] * s - pad_t
    return out


__all__ = ["xywh2xyxy", "bbox_iou", "rescale_boxes", "rescale_from_tile_frame"]
