"""Class-aware *merging* NMS over a fixed-size candidate pool, batched.

Counterpart of the reference package's ``ops/nms.py:43-250``.  The
reference loop (``utils/utils.py:235-273``) is not plain suppression: each
kept box becomes the confidence-weighted mean of every same-class box it
suppresses.  Its decisions depend only on the pre-merge coordinates, so the
sequential part is the keep/suppress recurrence over the score-sorted
suppression matrix — here a Python loop over the ``pool`` slots (64 on the
main path), vectorised over the batch — and cluster assignment and merging
vectorise completely (a suppressed box belongs to the FIRST keeper that
overlaps it).

Tie order: the reference's ``lax.top_k`` puts equal scores in index order;
``torch.topk`` promises no order, so the candidate pool is taken from a
stable descending ``torch.sort``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .boxes import bbox_iou, xywh2xyxy


def topk_stable(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, descending, equal values in index
    order (``lax.top_k``'s tie rule)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress_merge(det: torch.Tensor, top_scores: torch.Tensor,
                    nms_thres: float, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy keep/suppress + confidence-weighted merge over sorted rows.

    ``det`` (B, P, 7) rows ``(x1, y1, x2, y2, conf, cls_conf, cls_pred)`` in
    descending ``top_scores`` (B, P) order; ``-inf`` scores mark padding.
    """
    b, pool = top_scores.shape
    active0 = top_scores > -torch.inf

    # potential-suppression matrix over score order (diagonal included)
    ious = bbox_iou(det[:, :, None, :4], det[:, None, :, :4])      # (B, P, P)
    m = (ious > nms_thres) & (det[:, :, None, 6] == det[:, None, :, 6])
    m = m & active0[:, :, None] & active0[:, None, :]

    # three small launches a step: on bools, a > b is a & ~b
    suppressed = torch.zeros_like(active0)
    keeps = []
    for i in range(pool):
        is_keep = active0[:, i] > suppressed[:, i]
        keeps.append(is_keep)
        suppressed |= m[:, i] & is_keep[:, None]
    keep = torch.stack(keeps, dim=1)

    # cluster owner of each row = first keeper whose row suppresses it
    keeper_m = keep[:, :, None] & m                                  # (B, P, P)
    owner = keeper_m.to(torch.int32).argmax(dim=1)                   # first True
    member = keeper_m.any(dim=1) & active0

    w = torch.where(member, det[..., 4], 0.0)
    onehot = (owner[:, None, :] == torch.arange(pool, device=det.device)[None, :, None])
    wo = torch.where(onehot, w[:, None, :], 0.0)                     # (B, owner, row)
    wsum = wo.sum(dim=2)
    # an elementwise product and sum, not a matmul: no TF32 on the card
    wbox = (wo[..., None] * det[:, None, :, :4]).sum(dim=2)
    merged = wbox / wsum.clamp(min=1e-30)[..., None]

    out = torch.cat([torch.where(keep[..., None], merged, 0.0),
                     torch.where(keep[..., None], det[..., 4:], 0.0)], dim=-1)
    if pool == capacity:
        return out, keep
    # compact keepers (already in score order) into the first `capacity` rows
    # non-keepers (all-zero rows) land on row `pool`, past every keeper
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, pool)
    compact = torch.zeros((b, max(pool, capacity) + 1, 7), dtype=out.dtype, device=out.device)
    compact.scatter_(1, dest[..., None].expand(-1, -1, 7), out)
    n_keep = keep.sum(dim=1)
    valid = torch.arange(capacity, device=det.device)[None, :] < n_keep[:, None]
    return compact[:, :capacity], valid


def non_max_suppression_pooled(det: torch.Tensor, top_scores: torch.Tensor,
                               nms_thres: float = 0.4, capacity: int = 256
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merging NMS over a pre-selected candidate pool (the lazy-decode path,
    :func:`amyloid_yolo_tpu_torch.models.heads.decode_topk`).

    Returns ``(dets, valid)``: (B, capacity, 7) keepers in score order and
    their (B, capacity) validity mask.
    """
    return _suppress_merge(det, top_scores, nms_thres, capacity)


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.5,
                        nms_thres: float = 0.4, capacity: int = 256,
                        pool: Optional[int] = None, return_count: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """Batched merging NMS over densely decoded rows ``(B, N, 5+C)``
    ``(cx, cy, w, h, conf, cls...)`` (the ``lazy_decode=False`` path).

    ``pool`` rows (default ``capacity``) take part in suppression and
    merging; ``return_count`` adds ``n_candidates`` (B,) int32, the rows
    that passed ``conf_thres`` — more than ``pool`` means the fixed pool
    dropped candidates the reference's uncapped loop would have kept.
    """
    pool = pool or capacity
    boxes = xywh2xyxy(prediction[..., :4])
    conf = prediction[..., 4]
    cls_conf, cls_pred = prediction[..., 5:].max(dim=-1)
    # torch.max returns the first maximal index, like jnp.argmax
    score = torch.where(conf >= conf_thres, conf * cls_conf, -torch.inf)
    k = min(pool, score.shape[1])
    top_scores, top_idx = topk_stable(score, k)

    rows = torch.cat([boxes, conf[..., None], cls_conf[..., None],
                      cls_pred.to(boxes.dtype)[..., None]], dim=-1)
    det = torch.gather(rows, 1, top_idx[..., None].expand(-1, -1, 7))
    if k < pool:
        det = torch.nn.functional.pad(det, (0, 0, 0, pool - k))
        top_scores = torch.nn.functional.pad(top_scores, (0, pool - k),
                                             value=-torch.inf)
    dets, valid = _suppress_merge(det, top_scores, nms_thres, capacity)
    if return_count:
        n_candidates = (conf >= conf_thres).sum(dim=1).to(torch.int32)
        return dets, valid, n_candidates
    return dets, valid


def dense_to_ragged(dets, valid) -> List[Optional[np.ndarray]]:
    """Fixed-capacity output → the reference's ragged list (``None`` for an
    image without detections)."""
    if isinstance(dets, torch.Tensor):
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
    out: List[Optional[np.ndarray]] = []
    for d, v in zip(dets, valid):
        rows = d[v]
        out.append(rows if rows.shape[0] else None)
    return out


__all__ = ["topk_stable", "non_max_suppression_pooled", "non_max_suppression",
           "dense_to_ragged"]
