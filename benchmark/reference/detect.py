"""The reference's detection after the forward: decode, merging NMS over the
candidate pool, and the rescale to tile pixels.

* Decode (the original ``YOLOLayer``'s inference path): sigmoid on x, y,
  objectness and classes, ``exp`` on w, h times the anchor, all times the
  stride; rows in (anchor, row, col) order, heads concatenated.
* Candidates: rows with objectness ≥ ``conf_thres``, ordered by
  ``conf · max class`` descending (equal scores in row order); the first
  ``pool`` of them take part, as the configuration's pool caps them.
* The original's merging NMS loop (``utils/utils.py``), on the host: the
  best row suppresses every same-class row whose IoU with it (+1-pixel
  areas) exceeds ``nms_thres`` and becomes their confidence-weighted mean.
* Boxes ``× tile / model`` (square tiles, no letterbox pad).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def decode(raw: torch.Tensor, anchors, img_dim: int, classes: int) -> torch.Tensor:
    b, _, g, _ = raw.shape
    na = len(anchors)
    stride = img_dim / g
    p = raw.view(b, na, classes + 5, g, g).permute(0, 1, 3, 4, 2)
    grid = torch.arange(g, dtype=torch.float32, device=raw.device)
    aw = torch.tensor([a[0] for a in anchors], device=raw.device) / stride
    ah = torch.tensor([a[1] for a in anchors], device=raw.device) / stride
    cx = (torch.sigmoid(p[..., 0]) + grid[None, None, None, :]) * stride
    cy = (torch.sigmoid(p[..., 1]) + grid[None, None, :, None]) * stride
    w = torch.exp(p[..., 2]) * aw[None, :, None, None] * stride
    h = torch.exp(p[..., 3]) * ah[None, :, None, None] * stride
    rows = torch.cat([torch.stack([cx, cy, w, h, torch.sigmoid(p[..., 4])], dim=-1),
                      torch.sigmoid(p[..., 5:])], dim=-1)
    return rows.reshape(b, na * g * g, classes + 5)


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(ix2 - ix1 + 1, 0, None) * np.clip(iy2 - iy1 + 1, 0, None)
    a1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a1 + a2 - inter + 1e-16)


def nms_tile(rows: np.ndarray, conf_thres: float, nms_thres: float, pool: int
             ) -> Tuple[np.ndarray, int]:
    """``(keepers (k, 7) as x1 y1 x2 y2 conf cls_conf cls, candidates)``."""
    passing = rows[rows[:, 4] >= conf_thres]
    n_cand = passing.shape[0]
    if n_cand == 0:
        return np.zeros((0, 7), np.float32), 0
    cls_conf = passing[:, 5:].max(1)
    cls_pred = passing[:, 5:].argmax(1).astype(np.float32)
    order = np.argsort(-(passing[:, 4] * cls_conf), kind="stable")[:pool]
    cx, cy, w, h = (passing[order, j] for j in range(4))
    dets = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, passing[order, 4],
                     cls_conf[order], cls_pred[order]], axis=1)
    keep = []
    while dets.shape[0]:
        hit = (_iou(dets[0], dets[:, :4]) > nms_thres) & (dets[0, 6] == dets[:, 6])
        weights = dets[hit, 4:5]
        merged = dets[0].copy()
        merged[:4] = (weights * dets[hit, :4]).sum(0) / weights.sum()
        keep.append(merged)
        dets = dets[~hit]
    return np.stack(keep).astype(np.float32), n_cand


@torch.no_grad()
def detect(heads: List[torch.Tensor], yolos: List[dict], model_size: int, tile: int,
           conf_thres: float, nms_thres: float, pool: int
           ) -> List[Tuple[np.ndarray, int, np.ndarray]]:
    """Per image ``(keepers, candidate count, rows)`` from the reference's
    head maps, boxes in tile pixels: ``rows`` are every decoded row as
    ``x1 y1 x2 y2 conf`` and the class probabilities."""
    rows = torch.cat([decode(m, y["anchors"], model_size, y["classes"])
                      for m, y in zip(heads, yolos)], dim=1).cpu().numpy()
    scale = tile / model_size
    out = []
    for r in rows:
        k, n = nms_tile(r, conf_thres, nms_thres, pool)
        k[:, :4] *= scale
        cx, cy, w, h = (r[:, j] for j in range(4))
        xyxy = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1) * scale
        out.append((k, n, np.concatenate([xyxy, r[:, 4:]], axis=1).astype(np.float32)))
    return out
