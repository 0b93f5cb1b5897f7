"""The plain YOLOv4 training reference: its train-mode forward, darknet's
targets and the CIoU box loss, in plain float32 PyTorch.

    uint8 images → nearest resize, /255 → augmentation given its draws
    (:func:`~.train.augment`) → train-mode forward (BN on the batch's
    statistics; Mish, SPP pools, routes, shortcuts, upsamples) → the loss of
    every head → autograd backward → Adam on the sum when the step applies
    (:class:`~.train.Trainer`'s) → BN running statistics
    (:func:`~.model.running_update`).

Run with TF32 off (:func:`~.model.full_f32`).  It imports nothing of the
program: the layers come from :func:`.yolov4.layers`, and this module reads
each ``[yolo]`` block's training keys itself (:func:`layers`).

**Targets**, darknet's ``yolo_layer.c``, one truth row after another on
the host: a truth's best anchor by width-height IoU over the whole
``anchors`` table (the first of equal ones) is a positive at the truth's
cell on the head whose ``mask`` holds it; on every head, each other masked
anchor whose width-height IoU with the truth exceeds ``iou_thresh`` is a
positive too.  Where ``iou_thresh`` is 1 (off, or not stated), each head
takes the best of its own masked anchors, PyTorch-YOLOv3's rule, as the
port's YOLOv3 path does.  A later row that claims a
cell and anchor already taken writes its values over the earlier row's;
classes add up.  Not positive where a positive is, nor where a masked
anchor's width-height IoU with a truth exceeds 0.5.

**Loss** of a head: ``iou_normalizer`` × the mean over its positives of
``1 − CIoU`` between the decoded box (centre ``σ(t)·s − (s−1)/2 + cell``,
sides ``exp(t)·anchor``) and the truth, both in grid units, where the cfg
says ``iou_loss=ciou`` (else PyTorch-YOLOv3's four MSE terms); BCE on
objectness over the positives (scale 1) and the cells left as no-object
(scale 100); ``cls_normalizer`` × the BCE of the classes over the
positives.  CIoU is Zheng et al., arXiv:1911.08287, eq. 9–11, with ``α``
held constant in the backward as the authors' code holds it.

Departures from darknet, each deliberate:

* Means, not sums: every term is a mean over its cells, as in the port's
  YOLOv3 loss, where darknet adds each cell's delta.
* The no-object rule is PyTorch-YOLOv3's: the masked anchors above a
  width-height IoU of 0.5 at the truth's cell, not darknet's
  ``ignore_thresh`` of 0.7 on the predicted box's IoU with any truth.
* ``iou_thresh`` 1 gives PyTorch-YOLOv3's one positive a head, where
  darknet gives the best of the whole table alone.
* ``max_delta`` (darknet clips each delta to 5) is left out, as is
  darknet's hand-written gradient of the IoU terms.
* Adam at the configuration's rate, not the cfg's SGD with momentum,
  decay and ``burn_in``.
* The lab's augmentation in place of mosaic, ``jitter`` and the cfg's HSV
  ranges, and one input size (no ``random``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import yolov4
from .cfg import IGNORE_THRES, NOOBJ_SCALE, OBJ_SCALE, blocks, bn_key, conv_key
from .model import BN_EPS, running_update
from .train import Trainer as _Trainer
from .train import _bce, _mean, augment, resize

IOU_LOSSES = ("mse", "ciou")
EPS = 1e-9


def layers(path: str) -> Tuple[Dict[str, str], List[dict]]:
    """:func:`.yolov4.layers`, each yolo layer with the cfg's ``table`` (every
    anchor), ``mask``, ``iou_loss``, ``iou_normalizer``, ``cls_normalizer``
    and ``iou_thresh`` (defaults: MSE, 1, 1, 1)."""
    net, out = yolov4.layers(path)
    for layer, b in zip(out, blocks(path)[1:]):
        if layer["type"] != "yolo":
            continue
        flat = [float(a) for a in b["anchors"].split(",")]
        layer["table"] = [(flat[j], flat[j + 1]) for j in range(0, len(flat), 2)]
        layer["mask"] = [int(m) for m in b["mask"].split(",")]
        layer["iou_loss"] = b.get("iou_loss", "mse")
        if layer["iou_loss"] not in IOU_LOSSES:
            raise ValueError(f"{path}: iou_loss {layer['iou_loss']!r} is not in the reference")
        for key in ("iou_normalizer", "cls_normalizer", "iou_thresh"):
            layer[key] = float(b.get(key, 1.0))
    return net, out


def forward(sd: Dict[str, torch.Tensor], layer_list: List[dict], x: torch.Tensor,
            batch_stats: Dict[int, tuple]) -> List[torch.Tensor]:
    """Head maps ``(B, A·(5+C), g, g)`` of the NCHW float32 image ``x``, BN
    on the batch's statistics (biased variance); ``batch_stats[i] = (mean,
    var, n)`` of every BN ``i``."""
    keep = set()
    for layer in layer_list:
        if layer["type"] == "route":
            keep.update(layer["srcs"])
        elif layer["type"] == "shortcut":
            keep.add(layer["src"])
    saved: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    for i, layer in enumerate(layer_list):
        t = layer["type"]
        if t == "conv":
            b = None if layer["bn"] else sd[f"{conv_key(i)}.bias"]
            x = F.conv2d(x, sd[f"{conv_key(i)}.weight"], b, stride=layer["stride"],
                         padding=layer["pad"])
            if layer["bn"]:
                p = bn_key(i)
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                batch_stats[i] = (mean.detach(), var.detach(),
                                  x.shape[0] * x.shape[2] * x.shape[3])
                scale = sd[f"{p}.weight"] / torch.sqrt(var + BN_EPS)
                x = ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                     + sd[f"{p}.bias"][None, :, None, None])
            x = yolov4._activation(x, layer["act"])
        elif t == "upsample":
            x = F.interpolate(x, scale_factor=layer["factor"], mode="nearest")
        elif t == "maxpool":
            k, s = layer["k"], layer["stride"]
            if k == 2 and s == 1:
                x = F.max_pool2d(F.pad(x, (0, 1, 0, 1)), k, s)
            else:
                x = F.max_pool2d(x, k, s, padding=(k - 1) // 2)
        elif t == "route":
            x = torch.cat([saved[s] for s in layer["srcs"]], dim=1)
        elif t == "shortcut":
            x = x + saved[layer["src"]]
        elif t == "yolo":
            heads.append(x)
        if i in keep:
            saved[i] = x
    return heads


def _wh_iou(a: Tuple[float, float], w: float, h: float) -> float:
    """IoU of two boxes sharing a centre, the anchor's area taking 1e-16."""
    inter = min(a[0], w) * min(a[1], h)
    return inter / ((a[0] * a[1] + 1e-16) + w * h - inter)


def assign(targets, mask, yolo: dict, stride: float, g: int, nb: int
           ) -> Dict[str, torch.Tensor]:
    """Darknet's targets for one head (module docstring), row by row on the
    host; ``box`` holds each positive's truth ``(cx, cy, w, h)`` in grid
    units."""
    na, classes = len(yolo["mask"]), yolo["classes"]
    shape = (nb, na, g, g)
    obj = torch.zeros(shape, dtype=torch.bool)
    noobj = torch.ones(shape, dtype=torch.bool)
    tx, ty, tw, th = (torch.zeros(shape) for _ in range(4))
    tcls = torch.zeros(*shape, classes)
    box = torch.zeros(*shape, 4)
    table = [(aw / stride, ah / stride) for aw, ah in yolo["table"]]
    thresh = yolo["iou_thresh"]
    for row, ok in zip(targets.tolist(), mask.tolist()):
        bi, label = int(row[0]), int(row[1])
        if not ok or not 0 <= bi < nb:
            continue
        gx, gy, gw, gh = (torch.tensor(v * g, dtype=torch.float32).item() for v in row[2:6])
        gi, gj = min(max(int(gx), 0), g - 1), min(max(int(gy), 0), g - 1)
        ious = [_wh_iou(a, gw, gh) for a in table]
        among = range(len(table)) if thresh < 1.0 else yolo["mask"]
        best = max(among, key=lambda n: (ious[n], -n))
        for a, n in enumerate(yolo["mask"]):
            if ious[n] > IGNORE_THRES:
                noobj[bi, a, gj, gi] = False
            if n != best and not ious[n] > thresh:
                continue
            obj[bi, a, gj, gi] = True
            noobj[bi, a, gj, gi] = False
            tx[bi, a, gj, gi] = gx - math.floor(gx)
            ty[bi, a, gj, gi] = gy - math.floor(gy)
            tw[bi, a, gj, gi] = math.log(gw / table[n][0] + 1e-16)
            th[bi, a, gj, gi] = math.log(gh / table[n][1] + 1e-16)
            tcls[bi, a, gj, gi, min(max(label, 0), classes - 1)] = 1.0
            box[bi, a, gj, gi] = torch.tensor([gx, gy, gw, gh])
    return {"obj": obj, "noobj": noobj, "tx": tx, "ty": ty, "tw": tw, "th": th, "tcls": tcls,
            "box": box}


def ciou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CIoU of ``(cx, cy, w, h)`` rows ``a`` (predicted) and ``b`` (truth),
    arXiv:1911.08287 eq. 9–11: ``IoU − ρ²(a, b)/c² − α·v``, ``v =
    4/π²·(atan(w_b/h_b) − atan(w_a/h_a))²``, ``α = v/((1 − IoU) + v)``
    without a gradient; ``EPS`` in the three denominators."""
    ax1, ax2 = a[:, 0] - a[:, 2] / 2, a[:, 0] + a[:, 2] / 2
    ay1, ay2 = a[:, 1] - a[:, 3] / 2, a[:, 1] + a[:, 3] / 2
    bx1, bx2 = b[:, 0] - b[:, 2] / 2, b[:, 0] + b[:, 2] / 2
    by1, by2 = b[:, 1] - b[:, 3] / 2, b[:, 1] + b[:, 3] / 2
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    iou = inter / (a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter + EPS)
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    rho2 = (a[:, 0] - b[:, 0]) ** 2 + (a[:, 1] - b[:, 1]) ** 2
    v = 4.0 / math.pi ** 2 * (torch.atan(b[:, 2] / b[:, 3]) - torch.atan(a[:, 2] / a[:, 3])) ** 2
    with torch.no_grad():
        alpha = v / (1.0 - iou + v + EPS)
    return iou - rho2 / (cw ** 2 + ch ** 2 + EPS) - alpha * v


def head_loss(raw: torch.Tensor, yolo: dict, img_dim: int, targets, mask
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(loss, box term, positives)`` of one head's map."""
    b, _, g, _ = raw.shape
    na, nc = len(yolo["anchors"]), yolo["classes"]
    stride = img_dim / g
    p = raw.view(b, na, nc + 5, g, g).permute(0, 1, 3, 4, 2)
    t = {k: v.to(raw.device) for k, v in assign(targets.cpu(), mask.cpu(), yolo, stride, g,
                                                 b).items()}
    obj, noobj = t["obj"], t["noobj"]
    s = yolo["scale_x_y"]
    x = torch.sigmoid(p[..., 0]) * s - (s - 1) / 2
    y = torch.sigmoid(p[..., 1]) * s - (s - 1) / 2
    conf, cls = torch.sigmoid(p[..., 4]), torch.sigmoid(p[..., 5:])
    if yolo["iou_loss"] == "ciou":
        cells = torch.arange(g, dtype=torch.float32, device=raw.device)
        anc = torch.tensor(yolo["anchors"], device=raw.device) / stride
        pred = torch.stack([x + cells[None, None, None, :], y + cells[None, None, :, None],
                            torch.exp(p[..., 2]) * anc[None, :, None, None, 0],
                            torch.exp(p[..., 3]) * anc[None, :, None, None, 1]], dim=-1)
        box = (yolo["iou_normalizer"] * (1.0 - ciou(pred[obj], t["box"][obj])).mean()
               if bool(obj.any()) else pred.sum() * 0.0)
    else:
        box = (_mean((x - t["tx"]) ** 2, obj) + _mean((y - t["ty"]) ** 2, obj)
               + _mean((p[..., 2] - t["tw"]) ** 2, obj) + _mean((p[..., 3] - t["th"]) ** 2, obj))
    bce = _bce(conf, obj.to(torch.float32))
    loss = box + OBJ_SCALE * _mean(bce, obj) + NOOBJ_SCALE * _mean(bce, noobj)
    loss = loss + yolo["cls_normalizer"] * _mean(_bce(cls, t["tcls"]).mean(-1), obj)
    return loss, box.detach(), int(obj.sum())


def positives(layer_list: List[dict], img_dim: int, targets, mask, nb: int) -> List[int]:
    """The positives of each head for one batch's targets at ``img_dim``."""
    sides, cur = [], img_dim
    for layer in layer_list:   # the walk of the spatial sizes, as harness/flops.py
        if layer["type"] in ("conv", "maxpool"):
            cur //= layer["stride"]
        elif layer["type"] == "upsample":
            cur *= layer["factor"]
        elif layer["type"] == "route":
            cur = sides[layer["srcs"][0]]
        sides.append(cur)
    return [int(assign(targets.cpu(), mask.cpu(), layer, img_dim / sides[i], sides[i], nb)
                ["obj"].sum())
            for i, layer in enumerate(layer_list) if layer["type"] == "yolo"]


class Trainer(_Trainer):
    """:class:`~.train.Trainer` (parameters, Adam, the step count) with
    YOLOv4's micro-step; ``box_terms`` and ``head_positives`` hold the last
    micro-step's box term and positives of each head."""

    box_terms: List[torch.Tensor] = []
    head_positives: List[int] = []

    def micro(self, images_u8, targets, mask, draws: Optional[dict], size: int,
              apply: bool) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        x = resize(images_u8, size)
        if draws is not None:
            x, targets, mask = augment(x, targets, mask, draws)
        stats: Dict[int, tuple] = {}
        heads = forward(self.p, self.layers, x.permute(0, 3, 1, 2).contiguous(), stats)
        parts = [head_loss(h, y, size, targets, mask) for h, y in zip(heads, self.yolos)]
        loss = sum(p[0] for p in parts)
        self.box_terms = [p[1] for p in parts]
        self.head_positives = [p[2] for p in parts]
        loss.backward()
        grads = None
        if apply:
            grads = {k: self.p[k].grad.detach().clone() for k in self.keys}
            self._adam()
        running_update(self.p, stats)
        return loss.detach(), grads
