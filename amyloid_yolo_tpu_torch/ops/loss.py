"""YOLO loss (reference package ``ops/loss.py:58-127``).

Parity target: ``YOLOLayer.forward``'s training path
(the reference's ``models.py:171-222``):

* MSE, a mean over the assigned cells, on the x, y offsets and raw w, h;
* BCE on objectness over the assigned cells (scale 1) and the no-object
  cells (scale 100);
* BCE on the class probabilities over the assigned cells;
* the total is the sum of the six terms, summed over the heads.

Two rules of the reference package are kept exactly:

* :func:`_bce` clips the *probability* to ``[1e-12, 1 − 1e-7]`` before the
  logs, which bounds the loss and its gradient where a sigmoid saturates
  (random init reaches that region on the full model).
  ``F.binary_cross_entropy`` caps the log at −100 instead and has another
  backward, so it is not used.  The clip is ``minimum(maximum(·))``, whose
  gradient at a tie is halved as ``jnp.clip``'s is.
* :func:`_masked_mean` returns 0, not NaN, when its mask is empty.

YOLOv4's heads (``YoloSpec.iou_loss == "ciou"``, darknet's
``yolo_layer.c``) take one box term in place of the four MSE terms:
``iou_normalizer`` times the mean over the assigned cells of 1 − CIoU
(Zheng et al., arXiv:1911.08287, eq. 9–11) between the grid-sensitive
decoded box and its truth, both in grid units; the class term is scaled by
``cls_normalizer``; the objectness terms and the means are the port's.
:func:`ciou` takes ``α`` under ``no_grad``, as the authors' code does, and
leaves everything else to autograd.  Departure from darknet: its
hand-written gradient of the IoU terms (which replaces ``w² + h²`` by 1 in
``v``'s) is not reproduced.  ``ciou_heads`` counts the heads whose box term
was CIoU, on the host, without a sync.

A data-parallel step passes a ``reducer`` (``parallel.steps``): every
masked mean and ratio then hands it its shard's sum and count and divides
their sums over the shards, the global batch's mean, as the reference's
data-parallel step computes it.  Without one the arithmetic is unchanged.

The per-head metrics (cls_acc, recall50/75, precision, conf_obj/noobj)
stay tensors on the device; callers fetch them only when they log.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..graphspec import GraphSpec, YoloSpec
from ..models.heads import _grid_anchors, head_grid_tensors
from ..utils.spans import TRAIN_TARGETS, span
from .targets import build_targets

Metrics = Dict[str, torch.Tensor]

#: heads whose box term was CIoU, counted on the host as they are built
ciou_heads = 0
CIOU_EPS = 1e-9


Reducer = Optional[Callable[..., Tuple[torch.Tensor, ...]]]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, reducer: Reducer = None) -> torch.Tensor:
    cnt = mask.sum()
    total = (x * mask).sum()
    if reducer is not None:
        total, cnt = reducer(total, cnt)
    return torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)


def _ratio(num: torch.Tensor, den: torch.Tensor, reducer: Reducer = None) -> torch.Tensor:
    if reducer is not None:
        num, den = reducer(num, den)
    return num / (den + 1e-16)


def _bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # fills, not torch.tensor(..., device=...): a host copy would sync the stream
    p = torch.minimum(torch.maximum(p, p.new_full((), 1e-12)), p.new_full((), 1.0 - 1e-7))
    return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


def ciou(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """CIoU of ``(cx, cy, w, h)`` boxes (arXiv:1911.08287, eq. 9–11), over
    the last axis: ``IoU − ρ²/c² − α·v``, ``v = 4/π²·(atan(w_gt/h_gt) −
    atan(w/h))²``, ``α = v/((1 − IoU) + v)`` taken under ``no_grad``; ρ the
    centres' distance, c the diagonal of the smallest box holding both.
    ``CIOU_EPS`` keeps the union, c² and α's denominator off 0."""
    px, py, pw, ph = pred.unbind(-1)
    tx, ty, tw, th = truth.unbind(-1)
    p1x, p2x, p1y, p2y = px - pw / 2, px + pw / 2, py - ph / 2, py + ph / 2
    t1x, t2x, t1y, t2y = tx - tw / 2, tx + tw / 2, ty - th / 2, ty + th / 2
    inter = ((torch.minimum(p2x, t2x) - torch.maximum(p1x, t1x)).clamp(min=0)
             * (torch.minimum(p2y, t2y) - torch.maximum(p1y, t1y)).clamp(min=0))
    iou = inter / (pw * ph + tw * th - inter + CIOU_EPS)
    c2 = ((torch.maximum(p2x, t2x) - torch.minimum(p1x, t1x)) ** 2
          + (torch.maximum(p2y, t2y) - torch.minimum(p1y, t1y)) ** 2 + CIOU_EPS)
    rho2 = (px - tx) ** 2 + (py - ty) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(tw / th) - torch.atan(pw / ph)) ** 2
    with torch.no_grad():
        alpha = v / ((1 - iou) + v + CIOU_EPS)
    return iou - rho2 / c2 - alpha * v


def yolo_head_loss(raw: torch.Tensor, yolo: YoloSpec, img_dim: int,
                   target: torch.Tensor, target_mask: torch.Tensor, reducer: Reducer = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Loss and metrics of one head's raw NHWC map (f32)."""
    global ciou_heads
    t = head_grid_tensors(raw, yolo.anchors, img_dim, yolo.num_classes, yolo.scale_x_y)
    use_ciou = yolo.iou_loss == "ciou"
    with span(TRAIN_TARGETS):
        kw = {}
        if yolo.iou_thresh < 1.0:
            kw = dict(iou_thresh=yolo.iou_thresh, mask=yolo.mask,
                      all_anchors=_grid_anchors(yolo.all_anchors, t["stride"], raw.device))
        bt = build_targets(t["pred_boxes"], t["cls"], target, target_mask,
                           t["scaled_anchors"], yolo.ignore_thres, boxes=use_ciou, **kw)
    obj = bt["obj_mask"].to(torch.float32)
    noobj = bt["noobj_mask"].to(torch.float32)

    if use_ciou:
        ciou_heads += 1
        # both boxes the unit box where no truth is, so that no 0/0 (a
        # truth's empty sides) nor an overflowed exp meets the mask as NaN
        on = bt["obj_mask"][..., None]
        pair = ciou(torch.where(on, t["pred_boxes"], 1.0), torch.where(on, bt["tbox"], 1.0))
        loss_box = yolo.iou_normalizer * _masked_mean(1.0 - pair, obj, reducer)
        box_terms = {"iou": loss_box.detach()}
    else:
        loss_x = _masked_mean((t["x"] - bt["tx"]) ** 2, obj, reducer)
        loss_y = _masked_mean((t["y"] - bt["ty"]) ** 2, obj, reducer)
        loss_w = _masked_mean((t["w"] - bt["tw"]) ** 2, obj, reducer)
        loss_h = _masked_mean((t["h"] - bt["th"]) ** 2, obj, reducer)
        loss_box = loss_x + loss_y + loss_w + loss_h
        box_terms = {"x": loss_x.detach(), "y": loss_y.detach(), "w": loss_w.detach(),
                     "h": loss_h.detach()}
    bce_conf = _bce(t["conf"], bt["tconf"])
    loss_conf = (yolo.obj_scale * _masked_mean(bce_conf, obj, reducer)
                 + yolo.noobj_scale * _masked_mean(bce_conf, noobj, reducer))
    loss_cls = _masked_mean(_bce(t["cls"], bt["tcls"]).sum(dim=-1) / t["cls"].shape[-1], obj,
                            reducer)
    if yolo.cls_normalizer != 1.0:
        loss_cls = yolo.cls_normalizer * loss_cls
    total = loss_box + loss_conf + loss_cls

    with torch.no_grad():  # diagnostics (models.py:193-220)
        conf = t["conf"]
        cls_acc = 100.0 * _masked_mean(bt["class_mask"], obj, reducer)
        conf_obj = _masked_mean(conf, obj, reducer)
        conf_noobj = _masked_mean(conf, noobj, reducer)
        conf50 = (conf > 0.5).to(torch.float32)
        iou50 = (bt["iou_scores"] > 0.5).to(torch.float32)
        iou75 = (bt["iou_scores"] > 0.75).to(torch.float32)
        detected = conf50 * bt["class_mask"] * obj
        precision = _ratio((iou50 * detected).sum(), conf50.sum(), reducer)
        recall50 = _ratio((iou50 * detected).sum(), obj.sum(), reducer)
        recall75 = _ratio((iou75 * detected).sum(), obj.sum(), reducer)
    metrics = {
        "loss": total.detach(), **box_terms, "conf": loss_conf.detach(),
        "cls": loss_cls.detach(), "cls_acc": cls_acc, "recall50": recall50,
        "recall75": recall75, "precision": precision, "conf_obj": conf_obj,
        "conf_noobj": conf_noobj,
        "grid_size": raw.new_full((), float(t["grid_size"]), dtype=torch.float32),
    }
    return total, metrics


def yolo_loss(head_maps: Sequence[torch.Tensor], spec: GraphSpec, img_dim: int,
              target: torch.Tensor, target_mask: torch.Tensor, reducer: Reducer = None
              ) -> Tuple[torch.Tensor, List[Metrics]]:
    """Total loss over all heads (their sum, ``models.py:249-251``) and each
    head's metrics."""
    yolo_specs = [l for l in spec.layers if isinstance(l, YoloSpec)]
    total = torch.zeros((), dtype=torch.float32, device=head_maps[0].device)
    per_head = []
    for raw, ys in zip(head_maps, yolo_specs):
        loss, m = yolo_head_loss(raw, ys, img_dim, target, target_mask, reducer)
        total = total + loss
        per_head.append(m)
    return total, per_head


__all__ = ["yolo_loss", "yolo_head_loss", "ciou"]
