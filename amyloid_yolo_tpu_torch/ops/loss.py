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

A data-parallel step passes a ``reducer`` (``parallel.steps``): every
masked mean and ratio then hands it its shard's sum and count and divides
their sums over the shards, the global batch's mean, as the reference's
data-parallel step computes it.  Without one the arithmetic is unchanged.

The per-head metrics (cls_acc, recall50/75, precision, conf_obj/noobj)
stay tensors on the device; callers fetch them only when they log.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..graphspec import GraphSpec, YoloSpec
from ..models.heads import head_grid_tensors
from .targets import build_targets

Metrics = Dict[str, torch.Tensor]


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


def yolo_head_loss(raw: torch.Tensor, yolo: YoloSpec, img_dim: int,
                   target: torch.Tensor, target_mask: torch.Tensor, reducer: Reducer = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Loss and metrics of one head's raw NHWC map (f32)."""
    t = head_grid_tensors(raw, yolo.anchors, img_dim, yolo.num_classes, yolo.scale_x_y)
    bt = build_targets(t["pred_boxes"], t["cls"], target, target_mask,
                       t["scaled_anchors"], yolo.ignore_thres)
    obj = bt["obj_mask"].to(torch.float32)
    noobj = bt["noobj_mask"].to(torch.float32)

    loss_x = _masked_mean((t["x"] - bt["tx"]) ** 2, obj, reducer)
    loss_y = _masked_mean((t["y"] - bt["ty"]) ** 2, obj, reducer)
    loss_w = _masked_mean((t["w"] - bt["tw"]) ** 2, obj, reducer)
    loss_h = _masked_mean((t["h"] - bt["th"]) ** 2, obj, reducer)
    bce_conf = _bce(t["conf"], bt["tconf"])
    loss_conf = (yolo.obj_scale * _masked_mean(bce_conf, obj, reducer)
                 + yolo.noobj_scale * _masked_mean(bce_conf, noobj, reducer))
    loss_cls = _masked_mean(_bce(t["cls"], bt["tcls"]).sum(dim=-1) / t["cls"].shape[-1], obj,
                            reducer)
    total = loss_x + loss_y + loss_w + loss_h + loss_conf + loss_cls

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
        "loss": total.detach(), "x": loss_x.detach(), "y": loss_y.detach(),
        "w": loss_w.detach(), "h": loss_h.detach(), "conf": loss_conf.detach(),
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


__all__ = ["yolo_loss", "yolo_head_loss"]
