"""The reference's training micro-step, in plain float32 PyTorch.

    uint8 images → nearest resize (``src = floor(dst · in/out)``), /255 →
    augmentation given its draws → train-mode forward (:mod:`.model`) →
    YOLO loss → autograd backward (gradients sum over micro-batches) →
    Adam on the sum when the step applies → BN running statistics.

The augmentation is the configured policy, per image in this order:
pixel dropout, sharpen ``(1 − α)·x + α·(x ⊛ k)`` with zero padding, the
rotation about the centre and the translation resampled as three shear
passes (x, y, x: two-tap lerps with zeros outside), brightness clipped to
[0, 1], hue through HSV, horizontal flip; boxes through the forward affine
(corners rotated, re-boxed, clipped) and the flip, a box clipped to nothing
dropped.  The loss is the original ``YOLOLayer``'s (MSE on x, y, w, h and
BCE on objectness and classes over the assigned cells, the no-object cells
at scale 100), with the configuration's BCE rule: the probability clipped
to ``[1e-12, 1 − 1e-7]``, and an empty mean 0.  Targets are assigned on the
host, row by row, so that a later row wins a cell as in the original.
Adam is torch's defaults written out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .cfg import IGNORE_THRES, NOOBJ_SCALE, OBJ_SCALE
from .model import forward, running_update

SHARPEN = ((-1.0, -1.0, -1.0), (-1.0, 9.0, -1.0), (-1.0, -1.0, -1.0))
ADAM = {"betas": (0.9, 0.999), "eps": 1e-8}


def resize(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC uint8 → NHWC float32 at ``size``², values /255."""
    src = images_u8.shape[1]
    idx = torch.floor(torch.arange(size, dtype=torch.float64) * (src / size)).long()
    idx = idx.clamp(max=src - 1).to(images_u8.device)
    return images_u8[:, idx][:, :, idx].to(torch.float32) / 255.0


def _shear_rows(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Row r of image b resampled at ``x + shift[b, r]`` (NHWC)."""
    w = img.shape[2]
    k = torch.floor(shift)
    f = (shift - k)[..., None, None]
    x0 = torch.arange(w, device=img.device)[None, None, :] + k.long()[..., None]

    def tap(ix):
        inside = ((ix >= 0) & (ix < w))[..., None]
        v = torch.gather(img, 2, ix.clamp(0, w - 1)[..., None].expand_as(img))
        return torch.where(inside, v, 0.0)

    return (1.0 - f) * tap(x0) + f * tap(x0 + 1)


def _affine(img: torch.Tensor, angle: torch.Tensor, tx: torch.Tensor,
            ty: torch.Tensor) -> torch.Tensor:
    s = img.shape[1]
    c = (s - 1) / 2.0
    th = torch.deg2rad(angle)[:, None]
    cos, sin, t2 = torch.cos(th), torch.sin(th), torch.tan(th / 2.0)
    txs, tys = tx[:, None] * s, ty[:, None] * s
    c1 = c - cos * (c + txs) - sin * (c + tys)
    c2 = c + sin * (c + txs) - cos * (c + tys)
    d3 = -t2 * c
    d2 = c2 + sin * d3
    d1 = c1 - d3 - t2 * c2
    r = torch.arange(s, dtype=torch.float32, device=img.device)[None, :]
    out = _shear_rows(img, t2 * r + d1)
    out = _shear_rows(out.transpose(1, 2), -sin * r + d2).transpose(1, 2)
    return _shear_rows(out, t2 * r + d3)


def _hsv(rgb: torch.Tensor):
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    s = torch.where(mx > 0, d / mx.clamp(min=1e-12), 0.0)
    dd = d.clamp(min=1e-12)
    rc, gc, bc = (mx - r) / dd, (mx - g) / dd, (mx - b) / dd
    h = torch.where(mx == r, bc - gc, torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    return h, s, mx


def _rgb(h, s, v) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)
    table = torch.stack([torch.stack(c, -1) for c in
                         ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))])
    return torch.gather(table, 0, i[None, ..., None].expand(1, *i.shape, 3))[0]


def augment(img: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
            d: Dict[str, torch.Tensor]):
    """``(images, targets, mask)`` after the policy with the draws ``d``."""
    b = img.shape[0]
    img = torch.where(d["drop_u"][..., None] < d["drop_rate"][:, None, None, None], 0.0, img)
    k = torch.tensor(SHARPEN, device=img.device)[None, None].repeat(3, 1, 1, 1)
    sharp = F.conv2d(img.permute(0, 3, 1, 2), k, padding=1, groups=3).permute(0, 2, 3, 1)
    a = d["sharp_alpha"][:, None, None, None]
    img = (1 - a) * img + a * sharp
    angle, tr = d["angle"], d["trans"]
    img = _affine(img, angle, tr[:, 0], tr[:, 1])
    img = torch.clamp(img + d["bright"][:, None, None, None], 0.0, 1.0)
    h, s, v = _hsv(img)
    img = _rgb(torch.remainder(h + d["hue"][:, None, None], 1.0), s, v)
    img = torch.where(d["flip"][:, None, None, None], img.flip(2), img)

    bi = targets[:, 0].long().clamp(0, b - 1)
    th = torch.deg2rad(angle[bi])[:, None]
    cos, sin = torch.cos(th), torch.sin(th)
    cx, cy, w, hh = targets[:, 2:6].unbind(1)
    dx = torch.stack([-w / 2, w / 2, -w / 2, w / 2], 1)
    dy = torch.stack([-hh / 2, -hh / 2, hh / 2, hh / 2], 1)
    px, py = cx[:, None] + dx - 0.5, cy[:, None] + dy - 0.5
    qx = cos * px - sin * py + 0.5 + tr[bi, 0][:, None]
    qy = sin * px + cos * py + 0.5 + tr[bi, 1][:, None]
    x1, x2 = qx.amin(1).clamp(0, 1), qx.amax(1).clamp(0, 1)
    y1, y2 = qy.amin(1).clamp(0, 1), qy.amax(1).clamp(0, 1)
    ncx = (x1 + x2) / 2
    ncx = torch.where(d["flip"][bi], 1.0 - ncx, ncx)
    out = torch.stack([targets[:, 0], targets[:, 1], ncx, (y1 + y2) / 2, x2 - x1, y2 - y1], 1)
    return img, out, mask & (x2 - x1 > 1e-6) & (y2 - y1 > 1e-6)


def assign(targets, mask, anchors: List[Tuple[float, float]], stride: float, g: int,
           nb: int, classes: int) -> Dict[str, torch.Tensor]:
    """The original ``build_targets`` for one head, row by row on the host."""
    na = len(anchors)
    shape = (nb, na, g, g)
    obj = torch.zeros(shape, dtype=torch.bool)
    noobj = torch.ones(shape, dtype=torch.bool)
    tx, ty, tw, th = (torch.zeros(shape) for _ in range(4))
    tcls = torch.zeros(*shape, classes)
    anc = [(aw / stride, ah / stride) for aw, ah in anchors]
    for row, ok in zip(targets.tolist(), mask.tolist()):
        bi, label = int(row[0]), int(row[1])
        if not ok or not 0 <= bi < nb:
            continue
        gx, gy, gw, gh = (v * g for v in row[2:6])
        gx, gy, gw, gh = (torch.tensor(v, dtype=torch.float32).item() for v in (gx, gy, gw, gh))
        gi, gj = min(max(int(gx), 0), g - 1), min(max(int(gy), 0), g - 1)
        ious = []
        for aw, ah in anc:
            inter = min(aw, gw) * min(ah, gh)
            ious.append(inter / ((aw * ah + 1e-16) + gw * gh - inter))
        best = max(range(na), key=lambda a: (ious[a], -a))
        obj[bi, best, gj, gi] = True
        noobj[bi, best, gj, gi] = False
        for a in range(na):
            if ious[a] > IGNORE_THRES:
                noobj[bi, a, gj, gi] = False
        tx[bi, best, gj, gi] = gx - math.floor(gx)
        ty[bi, best, gj, gi] = gy - math.floor(gy)
        tw[bi, best, gj, gi] = math.log(gw / anc[best][0] + 1e-16)
        th[bi, best, gj, gi] = math.log(gh / anc[best][1] + 1e-16)
        tcls[bi, best, gj, gi, min(max(label, 0), classes - 1)] = 1.0
    return {"obj": obj, "noobj": noobj, "tx": tx, "ty": ty, "tw": tw, "th": th, "tcls": tcls}


def _bce(p, t):
    p = p.clamp(1e-12, 1.0 - 1e-7)
    return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


def _mean(x, m):
    return x[m].mean() if bool(m.any()) else x.sum() * 0.0


def head_loss(raw: torch.Tensor, yolo: dict, img_dim: int, targets, mask) -> torch.Tensor:
    b, _, g, _ = raw.shape
    na, nc = len(yolo["anchors"]), yolo["classes"]
    p = raw.view(b, na, nc + 5, g, g).permute(0, 1, 3, 4, 2)
    t = {k: v.to(raw.device) for k, v in assign(targets.cpu(), mask.cpu(), yolo["anchors"],
                                                 img_dim / g, g, b, nc).items()}
    obj, noobj = t["obj"], t["noobj"]
    x, y = torch.sigmoid(p[..., 0]), torch.sigmoid(p[..., 1])
    conf, cls = torch.sigmoid(p[..., 4]), torch.sigmoid(p[..., 5:])
    loss = (_mean((x - t["tx"]) ** 2, obj) + _mean((y - t["ty"]) ** 2, obj)
            + _mean((p[..., 2] - t["tw"]) ** 2, obj) + _mean((p[..., 3] - t["th"]) ** 2, obj))
    bce = _bce(conf, obj.to(torch.float32))
    loss = loss + OBJ_SCALE * _mean(bce, obj) + NOOBJ_SCALE * _mean(bce, noobj)
    return loss + _mean(_bce(cls, t["tcls"]).mean(-1), obj)


class Trainer:
    """The reference's state (parameters, Adam's moments, the step count)
    and its micro-step.  ``sd`` is copied; trainable are the leaves that
    end in ``.weight`` or ``.bias``."""

    def __init__(self, sd: Dict[str, torch.Tensor], layers: List[dict], lr: float):
        self.layers = layers
        self.yolos = [l for l in layers if l["type"] == "yolo"]
        self.lr = lr
        self.p = {k: v.detach().clone().to(torch.float32) for k, v in sd.items()
                  if not k.endswith("num_batches_tracked")}
        self.keys = [k for k in self.p if k.endswith((".weight", ".bias"))]
        for k in self.keys:
            self.p[k].requires_grad_(True)
        self.m = {k: torch.zeros_like(self.p[k]) for k in self.keys}
        self.v = {k: torch.zeros_like(self.p[k]) for k in self.keys}
        self.t = 0

    def micro(self, images_u8, targets, mask, draws: Optional[dict], size: int,
              apply: bool) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """One micro-batch; returns its loss and, when it applies, the
        gradient sum that Adam took."""
        x = resize(images_u8, size)
        if draws is not None:
            x, targets, mask = augment(x, targets, mask, draws)
        stats: Dict[int, tuple] = {}
        heads = forward(self.p, self.layers, x.permute(0, 3, 1, 2).contiguous(), train=True,
                        batch_stats=stats)
        loss = sum(head_loss(h, y, size, targets, mask) for h, y in zip(heads, self.yolos))
        loss.backward()
        grads = None
        if apply:
            grads = {k: self.p[k].grad.detach().clone() for k in self.keys}
            self._adam()
        running_update(self.p, stats)
        return loss.detach(), grads

    @torch.no_grad()
    def _adam(self) -> None:
        b1, b2 = ADAM["betas"]
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k in self.keys:
            g = self.p[k].grad
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            self.p[k].sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + ADAM["eps"]))
            self.p[k].grad = None
