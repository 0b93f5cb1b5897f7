"""Darknet/YOLOv3 inference over a static :class:`GraphSpec`, BN folded.

Counterpart of the reference package's ``models/darknet.py``:
:func:`init_params` (``:64-91``), :func:`fold_batchnorm` (``:321-344``),
:func:`fusible_residual_blocks` (``:347-375``) and :func:`apply_folded`
(``:403-489``).

Layout: activations are NCHW tensors in ``channels_last`` memory —
physically NHWC, which is what the kernels K1 and K2 read and write, and
what cuDNN's NHWC convolutions take.  Public functions take and return NHWC
tensors (input image, head maps), as the reference does.

bf16 contract of the convolutions that are not fused (``darknet.py:
462-467``): the conv accumulates in f32 and rounds to bf16, then the bf16
bias is added and the leaky runs in bf16 as ``where(v >= 0, v, v ·
bf16(0.1))`` — ``F.leaky_relu`` on bf16 rounds differently.  Every fusible
residual unit (all 23 of YOLOv3, the 64-channel one included) goes through
K2 when packs are given.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graphspec import (
    ConvSpec,
    GraphSpec,
    MaxPoolSpec,
    RouteSpec,
    ShortcutSpec,
    UpsampleSpec,
    YoloSpec,
)
from ..io.weights import StateDict, _bn_key, _conv_key, _np32
from ..kernels.conv_block import LEAKY_SLOPE, fused_residual_block, pack_block_weights

Folded = Dict[str, Dict[str, torch.Tensor]]
Packs = Dict[int, Tuple[torch.Tensor, ...]]

BN_EPS = 1e-5


def init_params(generator: torch.Generator, spec: GraphSpec) -> StateDict:
    """Random parameters with the reference's scheme (``weights_init_normal``,
    ``utils/utils.py:27-33``): conv weights ~N(0, 0.02), BN scale
    ~N(1, 0.02), BN shift 0, running mean 0 / var 1, head-conv biases 0."""
    sd: StateDict = {}
    for i in spec.conv_indices:
        layer: ConvSpec = spec.layers[i]  # type: ignore[assignment]
        k = layer.kernel
        sd[f"{_conv_key(i)}.weight"] = 0.02 * torch.randn(
            (layer.out_ch, layer.in_ch, k, k), generator=generator)
        if layer.batch_normalize:
            p = _bn_key(i)
            sd[f"{p}.weight"] = 1.0 + 0.02 * torch.randn((layer.out_ch,), generator=generator)
            sd[f"{p}.bias"] = torch.zeros(layer.out_ch)
            sd[f"{p}.running_mean"] = torch.zeros(layer.out_ch)
            sd[f"{p}.running_var"] = torch.ones(layer.out_ch)
            sd[f"{p}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        else:
            sd[f"{_conv_key(i)}.bias"] = torch.zeros(layer.out_ch)
    return sd


def fold_batchnorm(sd: Mapping[str, torch.Tensor], spec: GraphSpec) -> Folded:
    """Fold BN running stats into the convs: ``w' = w·γ/√(var+ε)``,
    ``b' = β − mean·γ/√(var+ε)``.  Computed in numpy float32 with the
    reference's operations, so the result is bit-identical to it.
    Returns ``{"conv_i": {"w": OIHW f32, "b": f32}}`` on the CPU."""
    folded: Folded = {}
    for i in spec.conv_indices:
        layer: ConvSpec = spec.layers[i]  # type: ignore[assignment]
        w = _np32(sd[f"{_conv_key(i)}.weight"])
        if layer.batch_normalize:
            p = _bn_key(i)
            inv = 1.0 / np.sqrt(_np32(sd[f"{p}.running_var"]) + np.float32(BN_EPS))
            g = _np32(sd[f"{p}.weight"]) * inv
            w = w * g[:, None, None, None]
            b = _np32(sd[f"{p}.bias"]) - _np32(sd[f"{p}.running_mean"]) * g
        else:
            b = _np32(sd[f"{_conv_key(i)}.bias"])
        folded[f"conv_{i}"] = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    return folded


def fusible_residual_blocks(spec: GraphSpec) -> Dict[int, Tuple[int, int, int]]:
    """Map start index → (conv1x1, conv3x3, shortcut) for the residual units
    K2 replaces: 1x1/s1 conv+BN+leaky, 3x3/s1 conv+BN+leaky back to the
    input width, shortcut from the unit's input, and neither intermediate
    read by any later route/shortcut."""
    blocks: Dict[int, Tuple[int, int, int]] = {}
    for i, layer in enumerate(spec.layers):
        if i + 2 >= len(spec.layers):
            break
        c1, c2, sc = layer, spec.layers[i + 1], spec.layers[i + 2]
        if not (isinstance(c1, ConvSpec) and c1.kernel == 1 and c1.stride == 1
                and c1.batch_normalize and c1.activation == "leaky"):
            continue
        if not (isinstance(c2, ConvSpec) and c2.kernel == 3 and c2.stride == 1
                and c2.batch_normalize and c2.activation == "leaky"
                and c2.in_ch == c1.out_ch and c2.out_ch == c1.in_ch):
            continue
        if not (isinstance(sc, ShortcutSpec) and sc.from_index == i - 1):
            continue
        if spec.consumers[i] - {i + 1} or spec.consumers[i + 1] - {i + 2}:
            continue
        blocks[i] = (i, i + 1, i + 2)
    return blocks


def pack_residual_blocks(folded: Folded, spec: GraphSpec,
                         dtype: torch.dtype = torch.bfloat16) -> Packs:
    """K2 packs (:func:`pack_block_weights`) of every fusible unit."""
    return {
        i: pack_block_weights(folded[f"conv_{i}"]["w"], folded[f"conv_{i}"]["b"],
                              folded[f"conv_{i + 1}"]["w"], folded[f"conv_{i + 1}"]["b"],
                              dtype)
        for i in fusible_residual_blocks(spec)
    }


def _leaky(v: torch.Tensor) -> torch.Tensor:
    # the slope is rounded to v's dtype first, as jnp's weakly typed 0.1 is
    return torch.where(v >= 0, v, v * torch.tensor(LEAKY_SLOPE, dtype=v.dtype))


def _maxpool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    # kernel-2/stride-1 pools get the reference's (0,1,0,1) ZERO pad
    # (models.py:50-51); symmetric (k-1)//2 padding of -inf otherwise
    if kernel == 2 and stride == 1:
        return F.max_pool2d(F.pad(x, (0, 1, 0, 1)), kernel, stride)
    return F.max_pool2d(x, kernel, stride, padding=(kernel - 1) // 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def apply_folded(folded: Folded, spec: GraphSpec, x: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 packs: Optional[Packs] = None,
                 block_fn: Callable[..., torch.Tensor] = fused_residual_block,
                 ) -> List[torch.Tensor]:
    """Inference forward over BN-folded params; returns the f32 NHWC map at
    each yolo layer.

    ``x``: (B, H, W, 3) image in [0, 1], any float dtype (cast to
    ``compute_dtype`` on entry).  ``packs`` (:func:`pack_residual_blocks`)
    sends each packed residual unit through ``block_fn`` — K2 by default;
    its plain version to compare with.  Without packs every layer runs
    unfused.
    """
    x = _nchw(x.to(compute_dtype)).contiguous(memory_format=torch.channels_last)

    # liveness: keep an activation only while a later route/shortcut needs it
    last_use: Dict[int, int] = {}
    for i, cons in enumerate(spec.consumers):
        if cons:
            last_use[i] = max(cons)

    saved: Dict[int, torch.Tensor] = {}
    head_maps: List[torch.Tensor] = []
    prev = x
    skip_until = -1
    for i, layer in enumerate(spec.layers):
        if i < skip_until:
            continue
        if packs is not None and i in packs:
            xin = _nhwc(prev.contiguous(memory_format=torch.channels_last))
            out = _nchw(block_fn(xin, *packs[i]))
            i_sc = i + 2  # liveness bookkeeping happens at the shortcut index
            if i_sc in last_use:
                saved[i_sc] = out
            for k in [k for k, lu in last_use.items()
                      if i <= lu <= i_sc and k in saved and k != i_sc]:
                del saved[k]
            prev = out
            skip_until = i + 3
            continue
        if isinstance(layer, ConvSpec):
            w = folded[f"conv_{i}"]["w"].to(compute_dtype)
            out = F.conv2d(prev, w, stride=layer.stride, padding=layer.pad)
            out = out + folded[f"conv_{i}"]["b"].to(compute_dtype)[None, :, None, None]
            if layer.activation == "leaky":
                out = _leaky(out)
        elif isinstance(layer, MaxPoolSpec):
            out = _maxpool(prev, layer.kernel, layer.stride)
        elif isinstance(layer, UpsampleSpec):
            out = F.interpolate(prev, scale_factor=layer.factor, mode="nearest")
        elif isinstance(layer, RouteSpec):
            out = torch.cat([saved[s] if s in saved else prev for s in layer.layers],
                            dim=1).contiguous(memory_format=torch.channels_last)
        elif isinstance(layer, ShortcutSpec):
            out = prev + saved[layer.from_index]
        elif isinstance(layer, YoloSpec):
            head_maps.append(_nhwc(prev.to(torch.float32)).contiguous())
            out = prev
        else:  # pragma: no cover
            raise TypeError(f"unknown layer spec {layer!r}")
        if i in last_use:
            saved[i] = out
        for k in [k for k, lu in last_use.items() if lu == i and k in saved]:
            if k != i:
                del saved[k]
        prev = out
    return head_maps


__all__ = ["init_params", "fold_batchnorm", "fusible_residual_blocks",
           "pack_residual_blocks", "apply_folded", "BN_EPS", "LEAKY_SLOPE"]
