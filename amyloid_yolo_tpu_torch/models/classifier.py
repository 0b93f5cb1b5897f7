"""The "consensus-of-2" secondary CNN of the CAA filter.

Counterpart of the reference package's ``models/classifier.py`` and of the
original ``Net`` (``core.py:161-208``): six conv3×3 (pad 1) + BN + ReLU +
maxpool2 stages of widths 16→32→48→64→80→96 over 256² RGB crops, then one
linear layer 96·4·4 → 3 multilabel logits (cored, diffuse, CAA); the
predictions are sigmoids.  :class:`Net` has the original module's state-dict
keys (``features.{4i}`` conv, ``features.{4i+1}`` BN, ``classifier.0``), so
a reference state dict loads as is.

The convolutions are PyTorch's (cuDNN on the card): the reference computes
them outside any Pallas kernel.  :func:`predict_probs` runs them in float32
with TF32 off.
"""

from __future__ import annotations

import pickle
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import no_tf32

STAGE_WIDTHS = (16, 32, 48, 64, 80, 96)
BN_EPS = 1e-5
NUM_CLASSES = 3
FC_IN = STAGE_WIDTHS[-1] * 4 * 4

StateDict = Dict[str, torch.Tensor]


class Net(nn.Module):
    """NCHW float crops (B, 3, 256, 256) → (B, 3) logits."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for out_ch in STAGE_WIDTHS:
            layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1),
                       nn.BatchNorm2d(out_ch, eps=BN_EPS), nn.ReLU(), nn.MaxPool2d(2, 2)]
            in_ch = out_ch
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Linear(FC_IN, NUM_CLASSES))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        return self.classifier(x.reshape(x.shape[0], -1))  # (C, H, W) flatten order


def init_params(generator: torch.Generator) -> StateDict:
    """Random weights in the reference's scheme: He-normal convs, zero
    biases, identity BN, a linear layer N(0, 0.01²)."""
    sd: StateDict = {}
    in_ch = 3
    for i, out_ch in enumerate(STAGE_WIDTHS):
        std = float(np.sqrt(2.0 / (9 * in_ch)))
        sd[f"features.{4 * i}.weight"] = torch.randn(out_ch, in_ch, 3, 3,
                                                     generator=generator) * std
        sd[f"features.{4 * i}.bias"] = torch.zeros(out_ch)
        sd[f"features.{4 * i + 1}.weight"] = torch.ones(out_ch)
        sd[f"features.{4 * i + 1}.bias"] = torch.zeros(out_ch)
        sd[f"features.{4 * i + 1}.running_mean"] = torch.zeros(out_ch)
        sd[f"features.{4 * i + 1}.running_var"] = torch.ones(out_ch)
        sd[f"features.{4 * i + 1}.num_batches_tracked"] = torch.tensor(0)
        in_ch = out_ch
    sd["classifier.0.weight"] = torch.randn(NUM_CLASSES, FC_IN, generator=generator) * 0.01
    sd["classifier.0.bias"] = torch.zeros(NUM_CLASSES)
    return sd


def from_jax_params(params: Mapping) -> StateDict:
    """The reference package's parameter tree (numpy leaves: ``conv_i``
    HWIO ``w``/``b``, ``bn_i`` ``scale``/``bias``/``mean``/``var``, ``fc``
    ``w`` (in, out)/``b``) → :class:`Net`'s state dict."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32))

    sd: StateDict = {}
    for i in range(len(STAGE_WIDTHS)):
        conv, bn = params[f"conv_{i}"], params[f"bn_{i}"]
        sd[f"features.{4 * i}.weight"] = t(np.transpose(conv["w"], (3, 2, 0, 1)))
        sd[f"features.{4 * i}.bias"] = t(conv["b"])
        sd[f"features.{4 * i + 1}.weight"] = t(bn["scale"])
        sd[f"features.{4 * i + 1}.bias"] = t(bn["bias"])
        sd[f"features.{4 * i + 1}.running_mean"] = t(bn["mean"])
        sd[f"features.{4 * i + 1}.running_var"] = t(bn["var"])
        sd[f"features.{4 * i + 1}.num_batches_tracked"] = torch.tensor(0)
    sd["classifier.0.weight"] = t(np.transpose(params["fc"]["w"]))
    sd["classifier.0.bias"] = t(params["fc"]["b"])
    return sd


def from_torch_pickle(path: str) -> StateDict:
    """The state dict of the original pickled ``Net`` module.  The pickle
    runs code when loaded: pass only a file of a trusted source."""
    mod = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.detach().cpu() for k, v in mod.state_dict().items()}


def load_normalization(path: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The original ``normalization.npy`` mean/std dict (``core.py:49``);
    the identity (mean 0, std 1) when the file is absent or unreadable."""
    if path is not None:
        try:
            d = np.load(path, allow_pickle=True).item()
            return (torch.as_tensor(np.asarray(d["mean"], np.float32)),
                    torch.as_tensor(np.asarray(d["std"], np.float32)))
        except (OSError, ValueError, KeyError, IndexError, TypeError,
                pickle.UnpicklingError):  # absent, or a git-LFS stub
            pass
    return torch.zeros(3), torch.ones(3)


@torch.inference_mode()
def predict_probs(net: Net, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid multilabel probabilities (cored, diffuse, CAA) of NHWC float32
    crops, in float32 with TF32 off."""
    with no_tf32():
        return torch.sigmoid(net(x.permute(0, 3, 1, 2).contiguous()))


__all__ = ["Net", "init_params", "from_jax_params", "from_torch_pickle",
           "load_normalization", "predict_probs", "STAGE_WIDTHS", "NUM_CLASSES"]
