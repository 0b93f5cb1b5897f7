"""The plain Darknet/YOLOv3 forward: ``F.conv2d``, batch norm, leaky ReLU,
nearest upsample, route and shortcut, in float32 on NCHW tensors.

Callers run it with TF32 off (:func:`full_f32`).  Eval mode normalises
with the running statistics; train mode with the batch's (biased
variance), and reports each BN's batch mean, variance and element count so
that the caller can update the running statistics.  Parameters are a state
dict in the original PyTorch-YOLOv3 layout (``module_list.{i}.conv_{i}``,
``module_list.{i}.batch_norm_{i}``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .cfg import bn_key, conv_key

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # the original's BatchNorm2d(momentum=0.9)
LEAKY = 0.1


@contextlib.contextmanager
def full_f32(allow_tf32: bool = False):
    """float32 convolutions and matrix products without TF32 (``allow_tf32``
    turns it on instead: the lower precision the controls use)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _kept(layers: List[dict]) -> set:
    keep = set()
    for layer in layers:
        if layer["type"] == "route":
            keep.update(layer["srcs"])
        elif layer["type"] == "shortcut":
            keep.add(layer["src"])
    return keep


def forward(sd: Dict[str, torch.Tensor], layers: List[dict], x: torch.Tensor,
            train: bool = False, batch_stats: Optional[Dict[int, tuple]] = None
            ) -> List[torch.Tensor]:
    """Head maps ``(B, A·(5+C), g, g)`` of the NCHW float32 image ``x``.
    With ``train``, ``batch_stats[i] = (mean, var, n)`` of every BN ``i``."""
    keep = _kept(layers)
    saved: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    for i, layer in enumerate(layers):
        t = layer["type"]
        if t == "conv":
            w = sd[f"{conv_key(i)}.weight"]
            b = None if layer["bn"] else sd[f"{conv_key(i)}.bias"]
            x = F.conv2d(x, w, b, stride=layer["stride"], padding=layer["pad"])
            if layer["bn"]:
                p = bn_key(i)
                if train:
                    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                    batch_stats[i] = (mean.detach(), var.detach(),
                                      x.shape[0] * x.shape[2] * x.shape[3])
                else:
                    mean, var = sd[f"{p}.running_mean"], sd[f"{p}.running_var"]
                scale = sd[f"{p}.weight"] / torch.sqrt(var + BN_EPS)
                x = ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                     + sd[f"{p}.bias"][None, :, None, None])
            if layer["leaky"]:
                x = F.leaky_relu(x, LEAKY)
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


@torch.no_grad()
def running_update(sd: Dict[str, torch.Tensor], batch_stats: Dict[int, tuple]) -> None:
    """``(1 − m)·old + m·batch`` with ``m = 0.9``, the variance unbiased."""
    for i, (mean, var, n) in batch_stats.items():
        p = bn_key(i)
        sd[f"{p}.running_mean"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        sd[f"{p}.running_var"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / (n - 1)))
