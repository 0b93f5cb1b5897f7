"""YOLO head decoding (reference package ``models/heads.py:29-238``).

Parity target: ``YOLOLayer.forward``'s inference path (the reference's
``models.py:127-169``): sigmoid on x, y, objectness and class logits; box
centre = sigmoid(x, y) + grid offset; size = exp(w, h) · anchor; all scaled
by the stride.  Rows go in (anchor, row, col) order per head and the heads
are concatenated — the reference's order, which NMS tie-breaking sees.

Head maps are NHWC ``(B, g, g, A·(5+C))`` with channel ``a·(5+C)+k``.

YOLOv4's grid-sensitive heads (``YoloSpec.scale_x_y`` = s ≠ 1, darknet's
``scale_x_y``) stretch the centre's sigmoid about the cell's middle:
``(σ(t)·s − (s−1)/2 + cell)·stride``.  At s = 1 nothing is computed for it,
so YOLOv3's decode runs the same operations as before.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch

from ..graphspec import GraphSpec, YoloSpec
from ..ops.nms import topk_stable


def _yolo_specs(spec: GraphSpec, n_maps: int) -> List[YoloSpec]:
    specs = [l for l in spec.layers if isinstance(l, YoloSpec)]
    if len(specs) != n_maps:
        raise ValueError(f"{n_maps} head maps for {len(specs)} yolo layers")
    return specs


@functools.lru_cache(maxsize=32)
def _grid_anchors(anchors: Tuple[Tuple[float, float], ...], stride: float,
                  device: torch.device) -> torch.Tensor:
    """(A, 2) anchors in grid units on ``device``, made once: a host→device
    copy per call would synchronise the stream mid-pipeline.  Made outside
    inference mode even when the first caller runs in it (a ``Detector``),
    since the training loss saves it for backward."""
    with torch.inference_mode(False):
        return (torch.tensor(anchors, dtype=torch.float32) / stride).to(device)


def grid_sensitive(xy: torch.Tensor, scale_x_y: float) -> torch.Tensor:
    """The centre's sigmoid ``xy`` stretched by ``scale_x_y`` about 0.5
    (``xy`` itself at 1)."""
    if scale_x_y == 1.0:
        return xy
    return xy * scale_x_y - (scale_x_y - 1.0) / 2


def decode_head(raw: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                img_dim: int, num_classes: int, scale_x_y: float = 1.0) -> torch.Tensor:
    """Decode one NHWC head map into ``(B, A·g·g, 5+C)`` rows."""
    b, g = raw.shape[0], raw.shape[1]
    na, nch = len(anchors), 5 + num_classes
    stride = img_dim / g
    pred = raw.reshape(b, g, g, na, nch).permute(0, 3, 1, 2, 4)

    xy = grid_sensitive(torch.sigmoid(pred[..., 0:2]), scale_x_y)
    wh = pred[..., 2:4]
    conf = torch.sigmoid(pred[..., 4:5])
    cls = torch.sigmoid(pred[..., 5:])

    gx = torch.arange(g, dtype=torch.float32, device=raw.device)
    grid = torch.stack(torch.meshgrid(gx, gx, indexing="xy"), dim=-1)  # (col, row)
    anc = _grid_anchors(tuple(anchors), stride, raw.device)
    boxes = torch.cat([(xy + grid[None, None]) * stride,
                       torch.exp(wh) * anc[None, :, None, None, :] * stride], dim=-1)
    return torch.cat([boxes, conf, cls], dim=-1).reshape(b, na * g * g, nch)


def decode_all(head_maps: List[torch.Tensor], spec: GraphSpec,
               img_dim: int) -> torch.Tensor:
    """Decode and concatenate every head: ``(B, Σ_h A·g_h², 5+C)``."""
    specs = _yolo_specs(spec, len(head_maps))
    return torch.cat([decode_head(m, ys.anchors, img_dim, ys.num_classes, ys.scale_x_y)
                      for m, ys in zip(head_maps, specs)], dim=1)


def decode_topk(head_maps: List[torch.Tensor], spec: GraphSpec, img_dim: int,
                conf_thres: float, pool: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score → top-k → sparse decode: the lazy form of :func:`decode_all`
    plus the NMS candidate selection.

    Over the full maps only the score ``sigmoid(obj) · sigmoid(max_c cls)``
    is computed; the box decode runs on the ``pool`` selected rows, with the
    same operations as :func:`decode_head` and the NMS front end's
    xywh → xyxy.

    Returns ``(det, top_scores, n_candidates)``: ``det`` (B, pool, 7) rows
    ``(x1, y1, x2, y2, conf, cls_conf, cls_pred)`` in descending score
    order, padding rows marked by ``top_scores == -inf``, and the (B,) int32
    count of conf-passing rows (the pool-overflow observable).
    """
    specs = _yolo_specs(spec, len(head_maps))
    b = head_maps[0].shape[0]
    nch = 5 + specs[0].num_classes
    device = head_maps[0].device

    scores = []
    for m, ys in zip(head_maps, specs):
        g, na = m.shape[1], len(ys.anchors)
        raw = m.reshape(b, g, g, na, nch)
        conf = torch.sigmoid(raw[..., 4]).float()
        # sigmoid is monotonic: max over class logits first, one sigmoid
        cls_conf = torch.sigmoid(raw[..., 5:].amax(dim=-1)).float()
        s = torch.where(conf >= conf_thres, conf * cls_conf, -torch.inf)
        scores.append(s.permute(0, 3, 1, 2).reshape(b, na * g * g))
    score = torch.cat(scores, dim=1)                                 # (B, N)

    k = min(pool, score.shape[1])
    top_scores, top_idx = topk_stable(score, k)
    if k < pool:
        top_idx = torch.nn.functional.pad(top_idx, (0, pool - k))
        top_scores = torch.nn.functional.pad(top_scores, (0, pool - k),
                                             value=-torch.inf)

    det = torch.zeros((b, pool, 7), dtype=torch.float32, device=device)
    off = 0
    for m, ys in zip(head_maps, specs):
        g, na = m.shape[1], len(ys.anchors)
        n_h = na * g * g
        stride = img_dim / g
        anc = _grid_anchors(ys.anchors, stride, device)

        in_head = (top_idx >= off) & (top_idx < off + n_h)
        local = torch.where(in_head, top_idx - off, 0)
        a = local // (g * g)
        rem = local % (g * g)
        r, c = rem // g, rem % g
        flat = (r * g + c) * na + a          # native (row, col, anchor) index
        rows = torch.gather(m.reshape(b, g * g * na, nch), 1,
                            flat[..., None].expand(-1, -1, nch))

        xy = grid_sensitive(torch.sigmoid(rows[..., 0:2]), ys.scale_x_y)
        grid = torch.stack([c, r], dim=-1).to(torch.float32)
        cxy = (xy + grid) * stride
        wh = torch.exp(rows[..., 2:4]) * anc[a] * stride
        conf = torch.sigmoid(rows[..., 4:5]).float()
        cls = torch.sigmoid(rows[..., 5:])
        cls_conf = cls.amax(dim=-1, keepdim=True).float()
        cls_pred = cls.argmax(dim=-1, keepdim=True).float()

        half = wh.float() / 2
        boxes = torch.cat([cxy.float() - half, cxy.float() + half], dim=-1)
        det_h = torch.cat([boxes, conf, cls_conf, cls_pred], dim=-1)
        det = torch.where(in_head[..., None], det_h, det)
        off += n_h
    n_candidates = (score > -torch.inf).sum(dim=1).to(torch.int32)
    return det, top_scores, n_candidates


def head_grid_tensors(raw: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                      img_dim: int, num_classes: int, scale_x_y: float = 1.0) -> dict:
    """Training-path decode (reference ``models/heads.py:198-238``): the
    tensors the YOLO loss reads, each (B, A, g, g, ...) — sigmoid x/y
    (stretched by ``scale_x_y``), raw w/h, sigmoid conf/cls, and pred boxes
    ``(cx, cy, w, h)`` in grid units — plus the anchors in grid units, the
    stride and the grid size."""
    b, g = raw.shape[0], raw.shape[1]
    na = len(anchors)
    stride = img_dim / g
    pred = raw.reshape(b, g, g, na, 5 + num_classes).permute(0, 3, 1, 2, 4)

    x = grid_sensitive(torch.sigmoid(pred[..., 0]), scale_x_y)
    y = grid_sensitive(torch.sigmoid(pred[..., 1]), scale_x_y)
    w = pred[..., 2]
    h = pred[..., 3]
    conf = torch.sigmoid(pred[..., 4])
    cls = torch.sigmoid(pred[..., 5:])

    gxs = torch.arange(g, dtype=torch.float32, device=raw.device)
    anc = _grid_anchors(tuple(anchors), stride, raw.device)
    pred_boxes = torch.stack([
        x + gxs[None, None, None, :],
        y + gxs[None, None, :, None],
        torch.exp(w) * anc[:, 0][None, :, None, None],
        torch.exp(h) * anc[:, 1][None, :, None, None],
    ], dim=-1)
    return {"x": x, "y": y, "w": w, "h": h, "conf": conf, "cls": cls,
            "pred_boxes": pred_boxes, "scaled_anchors": anc, "stride": stride,
            "grid_size": g}


__all__ = ["decode_head", "decode_all", "decode_topk", "head_grid_tensors",
           "grid_sensitive"]
