"""Weights from the seed, made on the device in a few large calls.

The reference scheme (the original's ``weights_init_normal``): conv
weights N(0, 0.02), BN scale N(1, 0.02), BN shift 0, running mean 0 and
variance 1, head-conv biases 0.  Each group is one ``randn`` over all its
layers, split into views.

For detection two constants follow, each worked out with the reference's
forward in float32 with TF32 off on a few seeded tiles.  The reference
scheme's N(0, 0.02) convolutions through 75 layers leave the head maps
spread by 1e-4 to 1e-7, where a trained head's logits spread by units, and
at that spread a bf16 logit near the objectness threshold resolves nothing
(its step is 0.0078 at 1.4).  So each head conv's weights are scaled to
give its maps a spread of ``head_std`` (:func:`scale_heads`), and the
objectness biases are raised to put a fixed share of the rows above the
threshold (:func:`objectness_shift`).  Both sides get the resulting
unfolded weights.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..reference.cfg import bn_key, conv_key
from ..reference.model import forward, full_f32


def reference_scheme(layers: List[dict], generator: torch.Generator,
                     device) -> Dict[str, torch.Tensor]:
    convs = [(i, l) for i, l in enumerate(layers) if l["type"] == "conv"]
    n_w = sum(l["cout"] * l["cin"] * l["k"] ** 2 for _, l in convs)
    n_bn = sum(l["cout"] for _, l in convs if l["bn"])
    w_all = torch.randn(n_w, generator=generator, device=device) * 0.02
    g_all = torch.randn(n_bn, generator=generator, device=device) * 0.02 + 1.0
    sd: Dict[str, torch.Tensor] = {}
    ow = ob = 0
    for i, l in convs:
        n = l["cout"] * l["cin"] * l["k"] ** 2
        sd[f"{conv_key(i)}.weight"] = w_all[ow:ow + n].view(l["cout"], l["cin"], l["k"], l["k"])
        ow += n
        c = l["cout"]
        if l["bn"]:
            p = bn_key(i)
            sd[f"{p}.weight"] = g_all[ob:ob + c]
            ob += c
            sd[f"{p}.bias"] = torch.zeros(c, device=device)
            sd[f"{p}.running_mean"] = torch.zeros(c, device=device)
            sd[f"{p}.running_var"] = torch.ones(c, device=device)
            sd[f"{p}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            sd[f"{conv_key(i)}.bias"] = torch.zeros(c, device=device)
    return sd


@torch.no_grad()
def scale_heads(sd: Dict[str, torch.Tensor], layers: List[dict], x: torch.Tensor,
                head_std: float) -> List[torch.Tensor]:
    """Scale each head conv's weights so that its maps over the NCHW image
    ``x`` have the standard deviation ``head_std`` (the head convs' biases
    are 0, so the maps scale with them); returns the scaled maps."""
    with full_f32():
        heads = forward(sd, layers, x)
    yolo_at = [i for i, l in enumerate(layers) if l["type"] == "yolo"]
    out = []
    for h, i in zip(heads, yolo_at):
        s = head_std / float(h.std())
        sd[f"{conv_key(i - 1)}.weight"].mul_(s)
        out.append(h * s)
    return out


@torch.no_grad()
def objectness_shift(sd: Dict[str, torch.Tensor], layers: List[dict],
                     heads: List[torch.Tensor], share: float, conf: float) -> float:
    """Add one constant to the objectness bias of every head conv: the one
    that puts ``share`` (within a quarter of it) of the rows of ``heads``
    above ``conf``, with the threshold halfway across the widest gap
    between two consecutive objectness logits there (the pattern of the
    repository's ``chip_smoke.py:raise_objectness``).  Returns it."""
    yolo_at = [i for i, l in enumerate(layers) if l["type"] == "yolo"]
    logits = []
    for h, i in zip(heads, yolo_at):
        nch = 5 + layers[i]["classes"]
        logits.append(h.permute(0, 2, 3, 1).reshape(-1, nch)[:, 4])
    logits = torch.cat(logits).float()
    k0 = max(4, int(share * logits.numel()))
    top = torch.topk(logits, k0 + k0 // 4 + 1).values
    lo = k0 - k0 // 4
    k = lo + int(torch.argmax(top[lo - 1:-1] - top[lo:]))
    shift = math.log(conf / (1 - conf)) - float(top[k - 1] + top[k]) / 2
    for i in yolo_at:
        head = layers[i - 1]
        if head["type"] != "conv" or head["bn"]:
            raise ValueError(f"layer {i - 1} before yolo layer {i} is not a head conv")
        sd[f"{conv_key(i - 1)}.bias"][4::5 + layers[i]["classes"]] += shift
    return shift
