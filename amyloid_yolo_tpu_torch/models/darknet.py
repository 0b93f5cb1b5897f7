"""Darknet/YOLOv3 over a static :class:`GraphSpec`: training and inference.

Counterpart of the reference package's ``models/darknet.py``:
:func:`init_params` (``:64-91``), :func:`apply` in eval and train mode
(``:155-320``, the train branch in its ``BN_FORM="reduce"`` form),
:func:`fold_batchnorm` (``:321-344``), :func:`fusible_residual_blocks`
(``:347-375``), :func:`apply_folded`
(``:403-489``), the ``int8_early`` path (:func:`int8_region`,
:func:`quantize_folded_int8`, :func:`calibrate_act_scales`,
:func:`apply_folded_int8`, ``:767-971``) and the ``int8_full`` path
(:func:`int8_full_conv_indices`, :func:`quantize_folded_int8_full`,
:func:`calibrate_act_scales_full`, :func:`apply_folded_int8_full`,
``:986-1230``).  The space-to-depth stems (inference and training) and
the planar training layout compute the same functions and are not ported.

Layout: float activations are NCHW tensors in ``channels_last`` memory —
physically NHWC, which is what the kernels K1 and K2 read and write, and
what cuDNN's NHWC convolutions take.  int8 activations are NHWC tensors.
Public functions take and return NHWC tensors (input image, head maps), as
the reference does.

bf16 contract of the convolutions that are not fused (``darknet.py:
462-467``): the conv accumulates in f32 and rounds to bf16, then the bf16
bias is added and the leaky runs in bf16 as ``where(v >= 0, v, v ·
bf16(0.1))`` — ``F.leaky_relu`` on bf16 rounds differently.  Every fusible
residual unit (all 23 of YOLOv3, the 64-channel one included) goes through
K2 when packs are given.

int8 contract (:mod:`amyloid_yolo_tpu_torch.ops.int8`): int8 convolutions
are exact int32 sums (``torch._int_mm``), rounded to bf16 where the
reference accumulates in bf16 — XLA's int8 convolution with a bf16 result
equals bf16 of the exact sum; the epilogue is ``acc · (s_in·ws) + b`` in
float32, multiply and add rounded separately; quantization divides by the
scale.  The convolutions that stay in bf16 (the RGB stem, the head convs)
accumulate in float32 over bf16 values and keep the float32 result.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple

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
from ..ops import int8 as q8
from ..utils.device import no_tf32

Folded = Dict[str, Dict[str, torch.Tensor]]
Packs = Dict[int, Tuple[torch.Tensor, ...]]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # torch BatchNorm2d(momentum=0.9), reference models.py:43


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


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _last_use(spec: GraphSpec) -> Dict[int, int]:
    """Layer → index of the last route/shortcut that reads it."""
    return {i: max(cons) for i, cons in enumerate(spec.consumers) if cons}


def _release(saved: Dict, last_use: Mapping[int, int], i: int) -> None:
    """Free the activations whose last reader is layer ``i``."""
    for k in [k for k, lu in last_use.items() if lu == i and k in saved]:
        if k != i:
            del saved[k]


def apply(params: Mapping[str, torch.Tensor], spec: GraphSpec, x: torch.Tensor, *,
          compute_dtype: torch.dtype = torch.float32, train: bool = False,
          reducer: Optional[Callable] = None):
    """Forward over *unfolded* parameters (a state dict in the reference
    layout, BN running statistics included); returns the f32 NHWC map at
    each yolo layer, and with ``train=True`` the pair ``(head_maps,
    new_stats)``.

    Each conv runs in ``compute_dtype`` (cast explicitly, no autocast); BN
    normalises in f32 and rounds back, and head convs add their bias in
    ``compute_dtype``, as the reference (``darknet.py:155-318``).

    Eval mode normalises with the running statistics and ``rsqrt(var + ε)``.
    Train mode is the reference's ``BN_FORM="reduce"`` branch: one-pass f32
    batch statistics ``mean`` and ``E[x²]``, ``var = max(E[x²] − mean², 0)``
    (biased) to normalise, and the running statistics
    ``(1 − m)·old + m·batch`` with ``m = BN_MOMENTUM`` and the unbiased
    ``var·n/(n − 1)``.  ``new_stats`` maps each ``…running_mean`` and
    ``…running_var`` key to its new (detached) value; gradients flow through
    the batch statistics, as autodiff of the reference does.

    ``reducer`` (train mode) makes the batch statistics those of a global
    batch split into shards (sync-BN, as the reference's data-parallel
    step computes them): each BN hands it its shard's per-channel ``Σx``
    and ``Σx²`` and takes back their sums over the shards; the count is the
    shard's times ``reducer.world`` (the shards are equal).  Without it the
    statistics are this batch's, computed exactly as before.
    """
    f32 = torch.float32
    prev = _cl(_nchw(x.to(compute_dtype)))
    last_use = _last_use(spec)
    saved: Dict[int, torch.Tensor] = {}
    head_maps: List[torch.Tensor] = []
    new_stats: StateDict = {}
    for i, layer in enumerate(spec.layers):
        if isinstance(layer, ConvSpec):
            w = params[f"{_conv_key(i)}.weight"].to(compute_dtype)
            out = F.conv2d(prev, w, stride=layer.stride, padding=layer.pad)
            if layer.batch_normalize:
                p = _bn_key(i)
                out32 = out.to(f32)
                if train:
                    n = out.shape[0] * out.shape[2] * out.shape[3]
                    if reducer is None:
                        mean = out32.mean(dim=(0, 2, 3))
                        ex2 = (out32 * out32).mean(dim=(0, 2, 3))
                    else:
                        s1, s2 = reducer(out32.sum(dim=(0, 2, 3)),
                                         (out32 * out32).sum(dim=(0, 2, 3)))
                        n = n * reducer.world
                        mean, ex2 = s1 / n, s2 / n
                    var = torch.clamp(ex2 - mean * mean, min=0.0)
                    with torch.no_grad():
                        unbiased = var * (n / max(n - 1, 1))
                        new_stats[f"{p}.running_mean"] = (
                            (1 - BN_MOMENTUM) * params[f"{p}.running_mean"] + BN_MOMENTUM * mean)
                        new_stats[f"{p}.running_var"] = (
                            (1 - BN_MOMENTUM) * params[f"{p}.running_var"]
                            + BN_MOMENTUM * unbiased)
                else:
                    mean = params[f"{p}.running_mean"].to(f32)
                    var = params[f"{p}.running_var"].to(f32)
                inv = torch.rsqrt(var + BN_EPS)
                g = (params[f"{p}.weight"].to(f32) * inv)[None, :, None, None]
                out = ((out32 - mean[None, :, None, None]) * g
                       + params[f"{p}.bias"].to(f32)[None, :, None, None]).to(compute_dtype)
            else:
                out = out + params[f"{_conv_key(i)}.bias"].to(compute_dtype)[None, :, None, None]
            if layer.activation == "leaky":
                out = _leaky(out)
        else:
            out = _plain_layer(layer, prev, saved, head_maps)
        if i in last_use:
            saved[i] = out
        _release(saved, last_use, i)
        prev = out
    return (head_maps, new_stats) if train else head_maps


def _plain_layer(layer, prev: torch.Tensor, saved: Dict[int, torch.Tensor],
                 head_maps: List[torch.Tensor]) -> torch.Tensor:
    """A layer other than a conv, on an NCHW float map."""
    if isinstance(layer, MaxPoolSpec):
        return _maxpool(prev, layer.kernel, layer.stride)
    if isinstance(layer, UpsampleSpec):
        return F.interpolate(prev, scale_factor=layer.factor, mode="nearest")
    if isinstance(layer, RouteSpec):
        return _cl(torch.cat([saved[s] if s in saved else prev for s in layer.layers], dim=1))
    if isinstance(layer, ShortcutSpec):
        return prev + saved[layer.from_index]
    if isinstance(layer, YoloSpec):
        head_maps.append(_nhwc(prev.to(torch.float32)).contiguous())
        return prev
    raise TypeError(f"unknown layer spec {layer!r}")  # pragma: no cover


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
    x = _cl(_nchw(x.to(compute_dtype)))
    return _folded_layers(folded, spec, x, {}, 0, compute_dtype, packs, block_fn)


def _folded_layers(folded: Folded, spec: GraphSpec, prev: torch.Tensor,
                   saved: Dict[int, torch.Tensor], start: int,
                   compute_dtype: torch.dtype, packs: Optional[Packs] = None,
                   block_fn: Callable[..., torch.Tensor] = fused_residual_block,
                   ) -> List[torch.Tensor]:
    """Layers ``start..`` of the folded forward from the NCHW map ``prev``
    and the live activations ``saved``."""
    last_use = _last_use(spec)
    head_maps: List[torch.Tensor] = []
    skip_until = -1
    for i, layer in enumerate(spec.layers):
        if i < start or i < skip_until:
            continue
        if packs is not None and i in packs:
            xin = _nhwc(_cl(prev))
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
        else:
            out = _plain_layer(layer, prev, saved, head_maps)
        if i in last_use:
            saved[i] = out
        _release(saved, last_use, i)
        prev = out
    return head_maps


# ---------------------------------------------------------------------------
# int8 inference: int8_early and int8_full
# ---------------------------------------------------------------------------

QParams = Dict[str, Dict[str, torch.Tensor]]


def int8_region(spec: GraphSpec, max_downsample: int = 4) -> int:
    """Last-exclusive layer index of the high-resolution prefix: every layer
    whose input map is at downsample factor <= ``max_downsample``, and no
    route or yolo layer (reference ``darknet.py:767-783``)."""
    factor = 1
    for i, layer in enumerate(spec.layers):
        if factor > max_downsample:
            return i
        if isinstance(layer, (RouteSpec, YoloSpec)):
            return i
        if isinstance(layer, (ConvSpec, MaxPoolSpec)) and layer.stride > 1:
            factor *= layer.stride
        elif isinstance(layer, UpsampleSpec):
            factor = max(1, factor // layer.factor)
    return len(spec.layers)


def int8_full_conv_indices(spec: GraphSpec) -> Set[int]:
    """Convs the ``int8_full`` path quantizes: every conv except the linear
    head convs and the narrow-input stem (``in_ch < 8``)."""
    return {i for i in spec.conv_indices
            if spec.layers[i].activation == "leaky"  # type: ignore[union-attr]
            and spec.layers[i].in_ch >= 8}  # type: ignore[union-attr]


def _quantize(folded: Folded, indices) -> QParams:
    """Per-output-channel symmetric int8 weights, in numpy float32 with the
    reference's operations (bit-identical): ``s = max|w|/127`` over each
    output channel, floored at 1e-12, ``wq = clip(round(w/s), ±127)``.
    Returns ``{"conv_i": {"wq": OIHW int8, "ws": f32, "b": f32}}``."""
    q: QParams = {}
    for i in sorted(indices):
        w = _np32(folded[f"conv_{i}"]["w"])
        s = np.abs(w).max(axis=(1, 2, 3)) / 127.0
        s = np.maximum(s, 1e-12).astype(np.float32)
        wq = np.clip(np.round(w / s[:, None, None, None]), -127, 127).astype(np.int8)
        q[f"conv_{i}"] = {"wq": torch.from_numpy(wq), "ws": torch.from_numpy(s),
                          "b": torch.from_numpy(_np32(folded[f"conv_{i}"]["b"]))}
    return q


def quantize_folded_int8(folded: Folded, spec: GraphSpec, upto: int) -> QParams:
    """int8 weights of every conv below ``upto`` (``int8_early``)."""
    return _quantize(folded, [i for i in spec.conv_indices if i < upto])


def quantize_folded_int8_full(folded: Folded, spec: GraphSpec) -> QParams:
    """int8 weights of every conv :func:`int8_full_conv_indices` names."""
    return _quantize(folded, int8_full_conv_indices(spec))


def _act_stat(t: torch.Tensor, percentile: float) -> torch.Tensor:
    """max |t| at ``percentile >= 100``, else that percentile of |t| by
    ``jnp.quantile``'s linear rule in float32: position ``q·(n−1)``, the
    two neighbouring order statistics weighted by its fraction.  A sort,
    because ``torch.quantile`` refuses more than 2**24 elements."""
    a = t.abs()
    if percentile >= 100.0:
        return a.amax()
    a = torch.sort(a.to(torch.float32).flatten()).values
    n = a.numel()
    f32 = torch.float32
    pos = torch.tensor(percentile / 100.0, dtype=f32) * (torch.tensor(float(n), dtype=f32) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    lo, hi = (min(max(int(v), 0), n - 1) for v in (low, high))
    return a[lo] * w_low.to(a.device) + a[hi] * w_high.to(a.device)


@torch.no_grad()
def _calibrate(folded: Folded, spec: GraphSpec, x: torch.Tensor, upto: int,
               percentile: float) -> Dict[str, float]:
    """f32 probe forward over layers ``< upto``; ``{"in": ..., "i": ...}``
    scales ``stat/127 + 1e-12`` of the input and of each layer's output."""
    f32 = torch.float32
    prev = _cl(_nchw(x.to(f32)))
    stats = {"in": _act_stat(prev, percentile)}
    last_use = _last_use(spec)
    saved: Dict[int, torch.Tensor] = {}
    with no_tf32():
        for i, layer in enumerate(spec.layers[:upto]):
            if isinstance(layer, ConvSpec):
                out = F.conv2d(prev, folded[f"conv_{i}"]["w"].to(f32),
                               stride=layer.stride, padding=layer.pad)
                out = out + folded[f"conv_{i}"]["b"].to(f32)[None, :, None, None]
                if layer.activation == "leaky":
                    out = _leaky(out)
            else:
                out = _plain_layer(layer, prev, saved, [])
            stats[str(i)] = _act_stat(out, percentile)
            if i in last_use:
                saved[i] = out
            _release(saved, last_use, i)
            prev = out
    keys = list(stats)
    values = torch.stack([stats[k].to(f32) for k in keys]).cpu().tolist()
    return {k: float(v) / 127.0 + 1e-12 for k, v in zip(keys, values)}


def calibrate_act_scales(folded: Folded, spec: GraphSpec, x: torch.Tensor, upto: int,
                         percentile: float = 100.0) -> Dict[str, float]:
    """Static activation scales of the ``int8_early`` region from a sample
    batch ``x`` (NHWC, [0, 1]): an f32 forward, TF32 off."""
    for layer in spec.layers[:upto]:
        if isinstance(layer, (RouteSpec, YoloSpec)):
            raise TypeError(f"int8 region cannot contain {layer!r}")
    return _calibrate(folded, spec, x, upto, percentile)


def calibrate_act_scales_full(folded: Folded, spec: GraphSpec, x: torch.Tensor,
                              percentile: float = 100.0) -> Dict[str, float]:
    """Static activation scales of every layer's output (``int8_full``)."""
    return _calibrate(folded, spec, x, len(spec.layers), percentile)


def _dequant(q: torch.Tensor, s: float) -> torch.Tensor:
    return q.to(torch.float32) * s


def _int8_conv(qp: Mapping[str, torch.Tensor], xq: torch.Tensor, s_in: float,
               layer: ConvSpec, int32_accum: bool) -> torch.Tensor:
    """Quantized conv + f32 epilogue (``acc·(s_in·ws) + b``, leaky): NHWC
    int8 in, f32 out.  The exact int32 sum is rounded to bf16 unless
    ``int32_accum``."""
    acc = q8.conv_int8(xq, qp["wq"], layer.stride, layer.pad)
    if not int32_accum:
        acc = acc.to(torch.bfloat16)
    y = acc.to(torch.float32) * (qp["ws"] * s_in) + qp["b"]
    return _leaky(y) if layer.activation == "leaky" else y


def _bf16_conv(folded: Folded, i: int, layer: ConvSpec, xf: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """A conv the int8 paths keep in ``compute_dtype``: NHWC ``xf`` (already
    in ``compute_dtype``) → f32 NHWC, the sum taken in f32 over the rounded
    values and kept in f32, plus the f32 bias (and leaky)."""
    w = folded[f"conv_{i}"]["w"].to(compute_dtype).to(torch.float32)
    y = _nhwc(F.conv2d(_nchw(xf.to(torch.float32)), w, stride=layer.stride,
                       padding=layer.pad))
    y = y + folded[f"conv_{i}"]["b"].to(torch.float32)
    return _leaky(y) if layer.activation == "leaky" else y


def _in_dtype(q: torch.Tensor, s: Optional[float], dtype: torch.dtype) -> torch.Tensor:
    """An int8 map (or a float one, ``s`` None) as a ``dtype`` map: the
    reference's ``q.astype(dtype) * dtype(s)``."""
    if s is None:
        return q.to(dtype)
    return q.to(dtype) * torch.tensor(s, dtype=dtype)


def apply_folded_int8(folded: Folded, qparams: QParams, act_scales: Mapping[str, float],
                      spec: GraphSpec, x: torch.Tensor, *, upto: int,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      int8_compute: bool = True) -> List[torch.Tensor]:
    """``int8_early``: layers ``< upto`` with int8 activations at the static
    ``act_scales`` (and int8 convs unless ``int8_compute=False``, which
    dequantizes into ``compute_dtype`` convs), then the standard folded
    path in ``compute_dtype``.  ``x`` is the f32 NHWC input in [0, 1]."""
    x = x.to(torch.float32)
    sc = q8.scale_tensors(act_scales, x.device)
    last_use = _last_use(spec)
    prev_q, prev_s = q8.quant(x, sc["in"]), act_scales["in"]
    saved_q: Dict[int, Tuple[torch.Tensor, float]] = {}
    for i, layer in enumerate(spec.layers[:upto]):
        y: Optional[torch.Tensor] = None
        if isinstance(layer, ConvSpec):
            if int8_compute:
                y = _int8_conv(qparams[f"conv_{i}"], prev_q, prev_s, layer, False)
            else:
                y = _bf16_conv(folded, i, layer, _in_dtype(prev_q, prev_s, compute_dtype),
                               compute_dtype)
        elif isinstance(layer, ShortcutSpec):
            aq, as_ = saved_q[layer.from_index]
            y = _dequant(prev_q, prev_s) + _dequant(aq, as_)
        elif isinstance(layer, MaxPoolSpec):
            y = _nhwc(_maxpool(_nchw(_dequant(prev_q, prev_s)), layer.kernel, layer.stride))
        elif isinstance(layer, UpsampleSpec):
            out_q, out_s = q8.upsample_int8(prev_q, layer.factor), prev_s
        else:  # pragma: no cover
            raise TypeError(f"int8 region cannot contain {layer!r}")
        if y is not None:
            out_q, out_s = q8.quant(y, sc[str(i)]), act_scales[str(i)]
        if i in last_use:
            saved_q[i] = (out_q, out_s)
        _release(saved_q, last_use, i)
        prev_q, prev_s = out_q, out_s

    # boundary: dequantize into compute_dtype and run the standard folded path
    prev = _cl(_nchw(_in_dtype(prev_q, prev_s, compute_dtype)))
    saved = {k: _cl(_nchw(_in_dtype(q, s, compute_dtype))) for k, (q, s) in saved_q.items()}
    return _folded_layers(folded, spec, prev, saved, upto, compute_dtype)


def apply_folded_int8_full(folded: Folded, qparams: QParams,
                           act_scales: Mapping[str, float], spec: GraphSpec,
                           x: torch.Tensor, *, compute_dtype: torch.dtype = torch.bfloat16,
                           s2d_stem=None, s2d_downs=None,
                           int32_accum_max_hw: int = 0) -> List[torch.Tensor]:
    """``int8_full``: every activation int8 at the static ``act_scales``,
    the convs of :func:`int8_full_conv_indices` int8 (exact int32 sums when
    the output map is at most ``int32_accum_max_hw`` wide, bf16-rounded
    above), the stem and the head convs in ``compute_dtype``.  Routes
    rescale each branch to the route's scale; shortcuts dequantize, add
    and requantize; max pool and upsample stay int8.  ``x`` is the f32 NHWC
    input in [0, 1]; returns the f32 NHWC head maps."""
    if s2d_stem is not None or s2d_downs:
        raise NotImplementedError("the space-to-depth stems are not ported yet "
                                  "(ROADMAP.md Queue 1)")
    x = x.to(torch.float32)
    sc = q8.scale_tensors(act_scales, x.device)
    quantized = int8_full_conv_indices(spec)
    last_use = _last_use(spec)
    # (map, scale) pairs; scale None marks a float map (the raw input, or a
    # head conv's output)
    saved: Dict[int, Tuple[torch.Tensor, Optional[float]]] = {}
    head_maps: List[torch.Tensor] = []
    prev_q, prev_s = x, None
    for i, layer in enumerate(spec.layers):
        out_s: Optional[float] = None
        if isinstance(layer, ConvSpec):
            if i in quantized:
                if prev_s is None:  # raw input into a quantized conv
                    prev_q, prev_s = q8.quant(prev_q, sc["in"]), act_scales["in"]
                out_hw = prev_q.shape[1] // layer.stride
                y = _int8_conv(qparams[f"conv_{i}"], prev_q, prev_s, layer,
                               out_hw <= int32_accum_max_hw)
                out_q, out_s = q8.quant(y, sc[str(i)]), act_scales[str(i)]
            else:
                y = _bf16_conv(folded, i, layer, _in_dtype(prev_q, prev_s, compute_dtype),
                               compute_dtype)
                if layer.activation == "leaky":
                    out_q, out_s = q8.quant(y, sc[str(i)]), act_scales[str(i)]
                else:
                    out_q = y  # the f32 map feeds the decode
        elif isinstance(layer, ShortcutSpec):
            aq, as_ = saved[layer.from_index]
            y = _dequant(prev_q, prev_s) + _dequant(aq, as_)
            out_q, out_s = q8.quant(y, sc[str(i)]), act_scales[str(i)]
        elif isinstance(layer, MaxPoolSpec):
            out_q, out_s = q8.maxpool_int8(prev_q, layer.kernel, layer.stride), prev_s
        elif isinstance(layer, UpsampleSpec):
            out_q, out_s = q8.upsample_int8(prev_q, layer.factor), prev_s
        elif isinstance(layer, RouteSpec):
            out_s = act_scales[str(i)]
            parts = []
            for k in layer.layers:
                q, s = saved[k] if k in saved else (prev_q, prev_s)
                parts.append(q8.quant(q if s is None else _dequant(q, s), sc[str(i)]))
            out_q = torch.cat(parts, dim=-1)
        elif isinstance(layer, YoloSpec):
            if prev_s is not None:
                raise ValueError(f"yolo layer {i} must read a linear head conv")
            head_maps.append(prev_q.contiguous())
            out_q = prev_q
        else:  # pragma: no cover
            raise TypeError(f"unknown layer spec {layer!r}")
        if i in last_use:
            saved[i] = (out_q, out_s)
        _release(saved, last_use, i)
        prev_q, prev_s = out_q, out_s
    return head_maps


__all__ = ["init_params", "apply", "fold_batchnorm", "fusible_residual_blocks",
           "pack_residual_blocks", "apply_folded", "int8_region",
           "quantize_folded_int8", "calibrate_act_scales", "apply_folded_int8",
           "int8_full_conv_indices", "quantize_folded_int8_full",
           "calibrate_act_scales_full", "apply_folded_int8_full",
           "BN_EPS", "BN_MOMENTUM", "LEAKY_SLOPE"]
