"""Ground-truth assignment (reference package ``ops/targets.py:42-214``,
its ``"scatter"`` form).

Parity target: the reference's ``build_targets`` (``utils/utils.py:276-330``):

* each GT box goes to its best wh-IoU anchor at the grid cell holding its
  centre (``gi = int(gx)``, ``gj = int(gy)``);
* ``noobj_mask`` is also cleared at (b, a, gj, gi) for every anchor ``a``
  whose wh-IoU with the GT exceeds ``ignore_thres``;
* regression targets: tx/ty fractional offsets, tw/th log size ratios
  (+1e-16), one-hot class targets;
* diagnostics: per-cell class correctness and the IoU of the *predicted*
  box with the GT (+1-pixel convention).

Duplicates: the reference resolves two GTs in one cell with torch-CPU's
last-writer-wins.  On CUDA, ``index_put_`` with repeated indices leaves the
winner unspecified, so the winner is elected explicitly — the highest
target row per flat cell key, by ``scatter_reduce(amax)`` — and only the
winners write values.  Masks and ``tcls`` are written by every valid row
with one value, so their duplicates agree.

Targets are a padded ``(T, 6)`` array of rows ``(batch_idx, class, cx, cy,
w, h)`` (normalized) with a validity mask; invalid rows write into one
extra drop cell past the grid, which is cut off at the end, so nothing
synchronises with the host.

YOLOv4's heads (``iou_thresh`` < 1) take darknet's rule
(``yolo_layer.c``) in place of the first point: the truth's best anchor by
width-height IoU over the cfg's whole table (``all_anchors``, the first of
equal ones), a positive here where this head's ``mask`` holds it, and every
other anchor of the mask whose width-height IoU with the truth exceeds
``iou_thresh``.  So a truth has from none to ``A`` positives a head.  Each
pair of a truth and an anchor is one candidate row of the scatter, ordered
by its truth's row: two truths that claim one cell and anchor leave the
later row's values there, as two truths that share a best anchor do under
the first rule.  The no-object rule is the same for both: the positives and
every anchor of the head above ``ignore_thres`` leave ``noobj_mask``.  With
``iou_thresh`` = 1 the first rule runs, op for op.

``boxes=True`` adds ``tbox``, each positive's truth ``(cx, cy, w, h)`` in
grid units (0 elsewhere), which the CIoU box term reads.

The reference's second form, ``"dense"`` (``AMYOLO_TARGETS_FORM``,
``_assemble_dense``, ``:155-211``), compares each target's cell key with
every cell instead of scattering, with bit-identical outputs; it spares the
TPU its slow scatters, and on the card it is no faster than the scatter
(ROADMAP.md, "Not ported, by rule").  The CPU tests hold a torch rendering
of it against both forms by putting it in place of
:func:`_assemble_scatter`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from .boxes import bbox_iou, bbox_wh_iou, xywh2xyxy


@functools.lru_cache(maxsize=32)
def _indices(mask: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``mask`` as a long tensor on ``device``, made once (a host→device
    copy a call would synchronise the stream)."""
    with torch.inference_mode(False):
        return torch.tensor(mask, dtype=torch.long).to(device)


def _truths(target: torch.Tensor, target_mask: torch.Tensor, nB: int, nG: int):
    """The target rows on a ``nG`` grid: ``(image, valid, class, centre,
    size, column, row)``, centre and size in grid units."""
    target = target.to(torch.float32)
    b = target[:, 0].long()
    valid = target_mask.bool() & (b >= 0) & (b < nB)
    labels = target[:, 1].long()
    gxy = target[:, 2:4] * nG
    gwh = target[:, 4:6] * nG
    gi = gxy[:, 0].long().clamp(0, nG - 1)
    gj = gxy[:, 1].long().clamp(0, nG - 1)
    return b, valid, labels, gxy, gwh, gi, gj


@torch.no_grad()
def build_targets(pred_boxes: torch.Tensor, pred_cls: torch.Tensor,
                  target: torch.Tensor, target_mask: torch.Tensor,
                  anchors: torch.Tensor, ignore_thres: float, *,
                  iou_thresh: float = 1.0, all_anchors: Optional[torch.Tensor] = None,
                  mask: Tuple[int, ...] = (), boxes: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """``pred_boxes`` (B, A, g, g, 4) and ``pred_cls`` (B, A, g, g, C) in grid
    units, ``anchors`` (A, 2) in grid units; returns the reference's target
    tensors, each (B, A, g, g) (``tcls`` (B, A, g, g, C)).  With
    ``iou_thresh`` < 1, darknet's rule over ``all_anchors`` (N, 2), in grid
    units, of which this head's are ``mask``; ``boxes`` adds ``tbox``."""
    if iou_thresh < 1.0:
        return _build_darknet(pred_boxes, pred_cls, target, target_mask, ignore_thres,
                              iou_thresh, all_anchors, mask, boxes)
    nB, nA, nG = pred_boxes.shape[0], pred_boxes.shape[1], pred_boxes.shape[2]
    nC = pred_cls.shape[-1]
    nT = target.shape[0]
    dev = pred_boxes.device
    shape = (nB, nA, nG, nG)
    b, valid, labels, gxy, gwh, gi, gj = _truths(target, target_mask, nB, nG)
    gx, gy = gxy[:, 0], gxy[:, 1]
    gw, gh = gwh[:, 0], gwh[:, 1]

    ious = bbox_wh_iou(anchors, gwh)        # (A, T)
    best_n = torch.argmax(ious, dim=0)       # (T,), the first maximum

    anchor_w = anchors[best_n, 0]
    anchor_h = anchors[best_n, 1]
    tx_v = gx - torch.floor(gx)
    ty_v = gy - torch.floor(gy)
    tw_v = torch.log(gw / anchor_w + 1e-16)
    th_v = torch.log(gh / anchor_h + 1e-16)
    bc = b.clamp(0, nB - 1)
    pred_at = pred_boxes[bc, best_n, gj, gi]       # (T, 4)
    pred_cls_at = pred_cls[bc, best_n, gj, gi]     # (T, C)
    target_boxes = torch.stack([gx, gy, gw, gh], dim=-1)
    iou_vals = bbox_iou(xywh2xyxy(pred_at), xywh2xyxy(target_boxes))
    cls_ok = (torch.argmax(pred_cls_at, dim=-1) == labels).to(torch.float32)
    labels_c = labels.clamp(0, nC - 1)

    ncell = nB * nA * nG * nG                 # cell `ncell` is the drop bucket
    key = torch.where(valid, ((bc * nA + best_n) * nG + gj) * nG + gi, ncell)

    # every anchor whose wh-IoU beats ignore_thres (utils/utils.py:314-315)
    a_ids = torch.arange(nA, device=dev)[:, None]
    key_ign = ((bc[None, :] * nA + a_ids) * nG + gj[None, :]) * nG + gi[None, :]
    key_ign = torch.where((ious > ignore_thres) & valid[None, :], key_ign, ncell).reshape(-1)
    columns = [tx_v, ty_v, tw_v, th_v, iou_vals, cls_ok]
    if boxes:
        columns += [gx, gy, gw, gh]
    values = torch.stack(columns, dim=-1)                                        # (T, 6|10)
    order = torch.arange(nT, device=dev)
    obj, noobj, vals, tcls = _assemble_scatter(ncell, nC, key, key_ign, order, valid, labels_c,
                                               values)
    return _unflatten(obj, noobj, vals, tcls, shape, nC)


def _build_darknet(pred_boxes, pred_cls, target, target_mask, ignore_thres: float,
                   iou_thresh: float, all_anchors: torch.Tensor, mask: Tuple[int, ...],
                   boxes: bool) -> Dict[str, torch.Tensor]:
    """Darknet's rule (module docstring): one candidate row a pair of this
    head's anchor and a truth, ``(A·T,)`` flat, anchor-major."""
    nB, nA, nG = pred_boxes.shape[0], pred_boxes.shape[1], pred_boxes.shape[2]
    nC = pred_cls.shape[-1]
    nT = target.shape[0]
    dev = pred_boxes.device
    shape = (nB, nA, nG, nG)
    b, valid, labels, gxy, gwh, gi, gj = _truths(target, target_mask, nB, nG)
    gx, gy = gxy[:, 0], gxy[:, 1]
    gw, gh = gwh[:, 0], gwh[:, 1]
    bc = b.clamp(0, nB - 1)

    ious_all = bbox_wh_iou(all_anchors, gwh)                 # (N, T)
    best = torch.argmax(ious_all, dim=0)                     # (T,), the first maximum
    m = _indices(tuple(mask), dev)                           # (A,)
    ious = ious_all.index_select(0, m)                       # (A, T)
    pos = (best[None, :] == m[:, None]) | (ious > iou_thresh)
    ok = (valid[None, :] & pos).reshape(-1)                  # (A·T,)

    a_ids = torch.arange(nA, device=dev)[:, None]
    at = (bc[None, :], a_ids, gj[None, :], gi[None, :])      # (A, T) by broadcasting
    anc = all_anchors.index_select(0, m)                     # (A, 2)
    tw_v = torch.log(gw[None, :] / anc[:, 0:1] + 1e-16)
    th_v = torch.log(gh[None, :] / anc[:, 1:2] + 1e-16)
    pred_at = pred_boxes[at]                                 # (A, T, 4)
    pred_cls_at = pred_cls[at]                               # (A, T, C)
    target_boxes = torch.stack([gx, gy, gw, gh], dim=-1)
    iou_vals = bbox_iou(xywh2xyxy(pred_at), xywh2xyxy(target_boxes)[None])
    cls_ok = (torch.argmax(pred_cls_at, dim=-1) == labels[None, :]).to(torch.float32)
    labels_c = labels.clamp(0, nC - 1)

    ncell = nB * nA * nG * nG
    cell = ((bc[None, :] * nA + a_ids) * nG + gj[None, :]) * nG + gi[None, :]  # (A, T)
    key = torch.where(ok, cell.reshape(-1), ncell)
    key_ign = torch.where((ious > ignore_thres) & valid[None, :], cell, ncell).reshape(-1)

    def each(v):   # a truth's value on each of its candidate rows
        return v[None, :].expand(nA, nT)

    columns = [each(gx - torch.floor(gx)), each(gy - torch.floor(gy)), tw_v, th_v, iou_vals,
               cls_ok]
    if boxes:
        columns += [each(v) for v in (gx, gy, gw, gh)]
    values = torch.stack(columns, dim=-1).reshape(nA * nT, -1)
    order = torch.arange(nT, device=dev).repeat(nA)
    obj, noobj, vals, tcls = _assemble_scatter(ncell, nC, key, key_ign, order, ok,
                                               labels_c.repeat(nA), values)
    return _unflatten(obj, noobj, vals, tcls, shape, nC)


def _unflatten(obj, noobj, vals, tcls, shape, nC) -> Dict[str, torch.Tensor]:
    vals = vals.reshape(*shape, vals.shape[-1])
    obj_mask = obj.reshape(shape)
    out = {
        "iou_scores": vals[..., 4],
        "class_mask": vals[..., 5],
        "obj_mask": obj_mask,
        "noobj_mask": noobj.reshape(shape),
        "tx": vals[..., 0], "ty": vals[..., 1], "tw": vals[..., 2], "th": vals[..., 3],
        "tcls": tcls.reshape(*shape, nC),
        "tconf": obj_mask.to(torch.float32),
    }
    if vals.shape[-1] > 6:
        out["tbox"] = vals[..., 6:10]
    return out


def _assemble_scatter(ncell, nC, key, key_ign, order, valid, labels_c, values):
    """The scatter form: ``(obj, noobj, vals, tcls)`` over the ``ncell``
    cells, flat (``vals`` (ncell, K) for ``values`` (T, K), ``tcls``
    (ncell·C,))."""
    dev = key.device
    # index_fill_ takes its value as a scalar argument: no host copy, no sync
    obj = torch.zeros(ncell + 1, dtype=torch.bool, device=dev).index_fill_(0, key, True)
    noobj = torch.ones(ncell + 1, dtype=torch.bool, device=dev).index_fill_(0, key, False)
    noobj.index_fill_(0, key_ign, False)

    # last-writer-wins: the highest target row of each cell writes the values
    winner = torch.full((ncell + 1,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, key, order, reduce="amax")
    key_w = torch.where(valid & (winner[key] == order), key, ncell)
    vals = torch.zeros(ncell + 1, values.shape[-1], dtype=torch.float32, device=dev)
    vals[key_w] = values

    # every valid row writes its class: distinct classes in one cell coexist
    tcls = torch.zeros((ncell + 1) * nC, dtype=torch.float32, device=dev).index_fill_(
        0, torch.where(valid, key * nC + labels_c, ncell * nC), 1.0)
    return obj[:ncell], noobj[:ncell], vals[:ncell], tcls[:ncell * nC]


__all__ = ["build_targets"]
