"""The plain YOLOv4 reference: its own ``.cfg`` reader, forward and decode.

YOLOv4 (Bochkovskiy, Wang and Liao, arXiv:2004.10934; darknet's
``cfg/yolov4.cfg``): CSPDarknet53 with Mish, SPP and PANet, and three
grid-sensitive heads.  Plain ``torch`` in float32 on NCHW tensors, run with
TF32 off (:func:`~.model.full_f32`); it imports nothing of the program.

* :func:`layers` reads a ``.cfg`` into the plain layer dicts of
  :func:`~.cfg.layers` (the same keys, so ``harness/flops.py`` and
  ``harness/weights.py`` walk it), and keeps each conv's activation
  (``act``: ``leaky``, ``mish`` or ``linear``; another raises) and each
  head's ``scale_x_y``.
* :func:`forward`: conv, BN with the running statistics (eval), leaky ReLU
  of slope 0.1, Mish ``x·tanh(softplus(x))``, max-pool, nearest upsample,
  route and shortcut.
* :func:`decode` and :func:`detect`: darknet's grid-sensitive decode,
  ``cx = (σ(tx)·s − (s−1)/2 + col)·stride``, then the lab's merging NMS
  (:func:`~.detect.nms_tile`) and the rescale to tile pixels.

Departures from darknet, each deliberate:

* NMS: the amyloid pipeline's class-aware merging NMS (conf 0.8, NMS 0.4)
  in place of YOLOv4's greedy DIoU-NMS with ``beta_nms`` 0.6: the system
  under test keeps the lab's post-processing for every model.
* Mish: ``F.softplus`` (threshold 20 above, none below) where darknet's
  ``softplus_activate`` also returns ``exp(x)`` below −20; in float32 the
  two agree (``log1p(exp(x))`` is ``exp(x)`` to rounding there).
* BN: PyTorch's ε 1e-5, the same as darknet's ``.00001f``.
* Max-pool: stride-1 pools pad with −∞ by ``(k − 1)/2`` on each side,
  which is darknet's ``pad = size − 1`` centred.
* Only the inference path: the ``[yolo]`` keys of darknet's training
  (``iou_loss``, ``iou_normalizer``, ``max_delta``, ``jitter``, ...) are
  read and ignored.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cfg import blocks, bn_key, conv_key
from .detect import nms_tile
from .model import BN_EPS, LEAKY

ACTIVATIONS = ("leaky", "mish", "linear")


def layers(path: str) -> Tuple[Dict[str, str], List[dict]]:
    """``(net block, layers)`` with :func:`~.cfg.layers`' keys, plus
    ``act`` on convs and ``scale_x_y`` on yolo layers."""
    bl = blocks(path)
    net, rest = bl[0], bl[1:]
    if net["type"] != "net":
        raise ValueError(f"{path}: the first block is not [net]")
    out: List[dict] = []
    chans: List[int] = []
    for i, b in enumerate(rest):
        t = b["type"]
        prev = chans[-1] if chans else int(net.get("channels", 3))
        if t == "convolutional":
            act = b.get("activation", "linear")
            if act not in ACTIVATIONS:
                raise ValueError(f"{path}: layer {i}: activation {act!r} is not in the reference")
            k = int(b["size"])
            layer = {"type": "conv", "cin": prev, "cout": int(b["filters"]), "k": k,
                     "stride": int(b["stride"]),
                     "pad": (k - 1) // 2 if int(b.get("pad", 0)) else 0,
                     "bn": int(b.get("batch_normalize", 0)) == 1,
                     "leaky": act == "leaky", "act": act}
        elif t == "upsample":
            layer = {"type": "upsample", "factor": int(b["stride"]), "cout": prev}
        elif t == "maxpool":
            layer = {"type": "maxpool", "k": int(b["size"]), "stride": int(b["stride"]),
                     "cout": prev}
        elif t == "route":
            srcs = [int(s) if int(s) >= 0 else i + int(s) for s in b["layers"].split(",")]
            layer = {"type": "route", "srcs": srcs, "cout": sum(chans[s] for s in srcs)}
        elif t == "shortcut":
            src = int(b["from"])
            src = src if src >= 0 else i + src
            layer = {"type": "shortcut", "src": src, "cout": chans[src]}
        elif t == "yolo":
            flat = [float(a) for a in b["anchors"].split(",")]
            table = [(flat[j], flat[j + 1]) for j in range(0, len(flat), 2)]
            anchors = [table[int(m)] for m in b["mask"].split(",")]
            layer = {"type": "yolo", "anchors": anchors, "classes": int(b["classes"]),
                     "scale_x_y": float(b.get("scale_x_y", 1.0)), "cout": prev}
        else:
            raise ValueError(f"{path}: layer type {t!r} is not in the reference")
        out.append(layer)
        chans.append(layer["cout"])
    return net, out


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "leaky":
        return F.leaky_relu(x, LEAKY)
    if act == "mish":
        return mish(x)
    return x


def forward(sd: Dict[str, torch.Tensor], layer_list: List[dict], x: torch.Tensor
            ) -> List[torch.Tensor]:
    """Head maps ``(B, A·(5+C), g, g)`` of the NCHW float32 image ``x``, BN
    with the running statistics."""
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
                scale = sd[f"{p}.weight"] / torch.sqrt(sd[f"{p}.running_var"] + BN_EPS)
                x = ((x - sd[f"{p}.running_mean"][None, :, None, None])
                     * scale[None, :, None, None] + sd[f"{p}.bias"][None, :, None, None])
            x = _activation(x, layer["act"])
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


def decode(raw: torch.Tensor, anchors, img_dim: int, classes: int,
           scale_x_y: float) -> torch.Tensor:
    """Rows ``(cx, cy, w, h, conf, classes…)`` in (anchor, row, col) order:
    darknet's ``σ(t)·s − (s−1)/2`` centre, ``exp`` sizes times the anchor."""
    b, _, g, _ = raw.shape
    na = len(anchors)
    stride = img_dim / g
    p = raw.view(b, na, classes + 5, g, g).permute(0, 1, 3, 4, 2)
    grid = torch.arange(g, dtype=torch.float32, device=raw.device)
    aw = torch.tensor([a[0] for a in anchors], device=raw.device)
    ah = torch.tensor([a[1] for a in anchors], device=raw.device)
    s = scale_x_y
    cx = (torch.sigmoid(p[..., 0]) * s - (s - 1) / 2 + grid[None, None, None, :]) * stride
    cy = (torch.sigmoid(p[..., 1]) * s - (s - 1) / 2 + grid[None, None, :, None]) * stride
    w = torch.exp(p[..., 2]) * aw[None, :, None, None]
    h = torch.exp(p[..., 3]) * ah[None, :, None, None]
    rows = torch.cat([torch.stack([cx, cy, w, h, torch.sigmoid(p[..., 4])], dim=-1),
                      torch.sigmoid(p[..., 5:])], dim=-1)
    return rows.reshape(b, na * g * g, classes + 5)


@torch.no_grad()
def detect(heads: List[torch.Tensor], yolos: List[dict], model_size: int, tile: int,
           conf_thres: float, nms_thres: float, pool: int
           ) -> List[Tuple[np.ndarray, int, np.ndarray]]:
    """Per image ``(keepers, candidate count, rows)`` as
    :func:`~.detect.detect` gives them, decoded with each head's
    ``scale_x_y``."""
    rows = torch.cat([decode(m, y["anchors"], model_size, y["classes"], y["scale_x_y"])
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
