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

The reference's second form, ``"dense"`` (``AMYOLO_TARGETS_FORM``,
``_assemble_dense``, ``:155-211``), compares each target's cell key with
every cell instead of scattering, with bit-identical outputs; it spares the
TPU its slow scatters, and on the card it is no faster than the scatter
(ROADMAP.md, "Not ported, by rule").  The CPU tests hold a torch rendering
of it against both forms by putting it in place of
:func:`_assemble_scatter`.
"""

from __future__ import annotations

from typing import Dict

import torch

from .boxes import bbox_iou, bbox_wh_iou, xywh2xyxy


@torch.no_grad()
def build_targets(pred_boxes: torch.Tensor, pred_cls: torch.Tensor,
                  target: torch.Tensor, target_mask: torch.Tensor,
                  anchors: torch.Tensor, ignore_thres: float) -> Dict[str, torch.Tensor]:
    """``pred_boxes`` (B, A, g, g, 4) and ``pred_cls`` (B, A, g, g, C) in grid
    units, ``anchors`` (A, 2) in grid units; returns the reference's target
    tensors, each (B, A, g, g) (``tcls`` (B, A, g, g, C))."""
    nB, nA, nG = pred_boxes.shape[0], pred_boxes.shape[1], pred_boxes.shape[2]
    nC = pred_cls.shape[-1]
    nT = target.shape[0]
    dev = pred_boxes.device
    shape = (nB, nA, nG, nG)

    target = target.to(torch.float32)
    b = target[:, 0].long()
    valid = target_mask.bool() & (b >= 0) & (b < nB)
    labels = target[:, 1].long()
    gxy = target[:, 2:4] * nG
    gwh = target[:, 4:6] * nG
    gx, gy = gxy[:, 0], gxy[:, 1]
    gw, gh = gwh[:, 0], gwh[:, 1]
    gi = gx.long().clamp(0, nG - 1)
    gj = gy.long().clamp(0, nG - 1)

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
    values = torch.stack([tx_v, ty_v, tw_v, th_v, iou_vals, cls_ok], dim=-1)   # (T, 6)
    order = torch.arange(nT, device=dev)
    obj, noobj, vals, tcls = _assemble_scatter(ncell, nC, key, key_ign, order, valid, labels_c,
                                               values)

    vals = vals.reshape(*shape, 6)
    obj_mask = obj.reshape(shape)
    return {
        "iou_scores": vals[..., 4],
        "class_mask": vals[..., 5],
        "obj_mask": obj_mask,
        "noobj_mask": noobj.reshape(shape),
        "tx": vals[..., 0], "ty": vals[..., 1], "tw": vals[..., 2], "th": vals[..., 3],
        "tcls": tcls.reshape(*shape, nC),
        "tconf": obj_mask.to(torch.float32),
    }


def _assemble_scatter(ncell, nC, key, key_ign, order, valid, labels_c, values):
    """The scatter form: ``(obj, noobj, vals, tcls)`` over the ``ncell``
    cells, flat (``vals`` (ncell, 6), ``tcls`` (ncell·C,))."""
    dev = key.device
    # index_fill_ takes its value as a scalar argument: no host copy, no sync
    obj = torch.zeros(ncell + 1, dtype=torch.bool, device=dev).index_fill_(0, key, True)
    noobj = torch.ones(ncell + 1, dtype=torch.bool, device=dev).index_fill_(0, key, False)
    noobj.index_fill_(0, key_ign, False)

    # last-writer-wins: the highest target row of each cell writes the values
    winner = torch.full((ncell + 1,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, key, order, reduce="amax")
    key_w = torch.where(valid & (winner[key] == order), key, ncell)
    vals = torch.zeros(ncell + 1, 6, dtype=torch.float32, device=dev)
    vals[key_w] = values

    # every valid row writes its class: distinct classes in one cell coexist
    tcls = torch.zeros((ncell + 1) * nC, dtype=torch.float32, device=dev).index_fill_(
        0, torch.where(valid, key * nC + labels_c, ncell * nC), 1.0)
    return obj[:ncell], noobj[:ncell], vals[:ncell], tcls[:ncell * nC]


__all__ = ["build_targets"]
