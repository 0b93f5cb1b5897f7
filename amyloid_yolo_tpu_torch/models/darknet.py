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
``:986-1230``), and the reference's layout options: the space-to-depth
(s2d) stem of inference (:func:`make_s2d_stem`, :func:`make_s2d_stem_int8`,
:func:`s2d_stem_forward`, ``:492-765``) and training (``apply(s2d_stem=
True)``, ``:215-240``), the s2d downsample of ``int8_full``
(:func:`make_s2d_down_int8`), the planar input (``apply(input_layout=
"planar")``) and the BN statistics as matrix products (``apply(bn_form=
"matmul")``, :mod:`..ops.bnstats`).

Every forward, the height-sharded one of ``parallel/spatial.py`` included,
runs the graph through :func:`walk`, which keeps each value while a later
layer reads it and takes a fused kernel (a K2 residual unit, an SPP block,
the s2d stem) as one run of layers.  A forward gives it one per-layer
step, built on the per-layer functions (:func:`conv`, the BN steps,
:func:`folded_conv`, :func:`plain_layer`).

Layout: float activations are NCHW tensors in ``channels_last`` memory —
physically NHWC, which is what the kernels K1 and K2 read and write, and
what cuDNN's NHWC convolutions take.  int8 activations are NHWC tensors.
Public functions take and return NHWC tensors (input image, head maps), as
the reference does.

bf16 contract of the convolutions that are not fused (``darknet.py:
462-467``): the conv accumulates in f32 and rounds to bf16, then the bf16
bias is added and the leaky runs in bf16 as ``where(v >= 0, v, v ·
bf16(0.1))`` — ``F.leaky_relu`` on bf16 rounds differently.  A Mish conv
(YOLOv4's CSPDarknet53) adds the bias the same way, then computes Mish in
float32 on that bf16 sum and rounds once to bf16 (:func:`activate`).  On the
card the bias and the activation of the folded forward are one in-place pass
with those roundings (``kernels/bias_leaky.py``; Mish there to one bf16 ulp).
The int8 executors and the s2d stem take YOLOv3's leaky convs only and refuse
a graph with Mish convs or grid-sensitive heads.  Every fusible
residual unit (all 23 of YOLOv3, the 64-channel one included) goes through
K2 when packs are given; every SPP block given to the folded forward
(YOLOv4's stride-1 pools and their route, :func:`spp_blocks`) is one pass
of ``kernels/spp_pool.py`` whose output equals the layers' bit for bit.  A
route given to the folded forward in its plan (:func:`route_slices`:
YOLOv4's CSP joins) copies nothing: each member's epilogue writes into its
channel slice of the route's map, with the same values.

int8 contract (:mod:`amyloid_yolo_tpu_torch.ops.int8`): int8 convolutions
are exact int32 sums (``torch._int_mm``), rounded to bf16 where the
reference accumulates in bf16 — XLA's int8 convolution with a bf16 result
equals bf16 of the exact sum; the epilogue is ``acc · (s_in·ws) + b`` in
float32, multiply and add rounded separately; quantization multiplies by
the scale's reciprocal, as the reference's compiled program does
(:func:`~..ops.int8.quant`).  The convolutions that stay in bf16 (the RGB
stem, the head convs) accumulate in float32 over bf16 values and keep the
float32 result.
"""

from __future__ import annotations

import functools
import itertools
import os
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Set, Tuple

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
from ..kernels.bias_leaky import (LEAKY_SLOPE, bias_leaky, bias_mish, leaky_where as _leaky,
                                  mish_wide)
from ..kernels.conv_block import fused_residual_block, pack_block_weights
from ..kernels.spp_pool import MAX_KERNEL, MAX_POOLS, spp_pool
from ..ops import bnstats
from ..ops import int8 as q8
from ..utils.device import no_tf32

Folded = Dict[str, Dict[str, torch.Tensor]]
Packs = Dict[int, Tuple[torch.Tensor, ...]]
#: the kernel's own Mish epilogue, which takes ``into`` (see :func:`folded_conv`)
_bias_mish = bias_mish

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # torch BatchNorm2d(momentum=0.9), reference models.py:43
#: train-mode BN statistics form, ``"reduce"`` or ``"matmul"`` (see
#: :func:`apply`); ``apply(bn_form=None)`` reads it at each call
BN_FORM = os.environ.get("AMYOLO_BN_FORM", "reduce")


def resolve_bn_form(bn_form: Optional[str]) -> str:
    """``bn_form`` (``None``: :data:`BN_FORM`, read at each call), or
    ``ValueError`` unless it is ``"reduce"`` or ``"matmul"``: no form falls
    back to another quietly."""
    form = BN_FORM if bn_form is None else bn_form
    if form not in ("reduce", "matmul"):
        raise ValueError(f"unknown BN form {form!r} (AMYOLO_BN_FORM / bn_form): "
                         "'reduce' or 'matmul'")
    return form


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


class SppBlock(NamedTuple):
    """A spatial pyramid pooling block (YOLOv4's SPP): stride-1 pools of
    odd ``kernels`` over layer ``input``, joined with it by the route at
    index ``route`` in the ``order`` of its members (a pool's position in
    ``kernels``, ``-1`` for the input)."""

    input: int
    kernels: Tuple[int, ...]
    order: Tuple[int, ...]
    route: int


def spp_blocks(spec: GraphSpec) -> Dict[int, SppBlock]:
    """Map the first pool's index → :class:`SppBlock` for every run of
    layers that is: a stride-1 max-pool of an odd kernel from 3 to
    ``MAX_KERNEL`` over the layer before it; up to ``MAX_POOLS - 1``
    ``[route]`` layers back to that input, each followed by another such
    pool; a route whose members are those pools and the input, each once,
    in any order; and no layer but that route reading a pool or one of the
    routes back.  Those are the blocks :func:`~..kernels.spp_pool.spp_pool`
    takes on any map."""
    layers = spec.layers

    def pool(j: int) -> bool:
        l = layers[j] if j < len(layers) else None
        return (isinstance(l, MaxPoolSpec) and l.stride == 1 and l.kernel % 2 == 1
                and 3 <= l.kernel <= MAX_KERNEL)

    blocks: Dict[int, SppBlock] = {}
    taken = -1
    for i in [i for i, l in enumerate(layers) if isinstance(l, MaxPoolSpec)]:
        if i <= taken or i == 0 or not pool(i):
            continue
        src, pools, j = i - 1, [i], i + 1
        while (isinstance(layers[j] if j < len(layers) else None, RouteSpec)
               and layers[j].layers == (src,) and pool(j + 1)):
            pools.append(j + 1)
            j += 2
        end = layers[j] if j < len(layers) else None
        if (len(pools) <= MAX_POOLS and isinstance(end, RouteSpec)
                and sorted(end.layers) == sorted([src, *pools])
                and all(spec.consumers[p] == {j} for p in pools)
                and not any(spec.consumers[p - 1] for p in pools[1:])):
            blocks[i] = SppBlock(src, tuple(layers[p].kernel for p in pools),
                                 tuple(-1 if m == src else pools.index(m) for m in end.layers),
                                 j)
            taken = j
    return blocks


def route_slices(spec: GraphSpec) -> Dict[int, Tuple[int, ...]]:
    """Map route index → its members' channel offsets in its map, in the
    route's order, for every route the folded forward joins in place: two
    members or more, each a Mish conv that no other layer reads (the route
    is its one consumer, and the layer after it is the route itself or
    another route, which does not read it as its input).  Each such
    member's Mish epilogue, the one that takes a destination, writes into
    its slice of the route's map, and the route copies nothing.  No conv
    inside a run of :func:`walk` qualifies: K2's convs are read by the
    unit's next layer, and the s2d stem's layer 1 could only join a route
    with layer 0, which no layer reads."""
    plan: Dict[int, Tuple[int, ...]] = {}
    for r, layer in enumerate(spec.layers):
        if not (isinstance(layer, RouteSpec) and len(set(layer.layers)) == len(layer.layers) >= 2):
            continue
        if all(isinstance(spec.layers[m], ConvSpec) and spec.layers[m].activation == "mish"
               and spec.consumers[m] == {r}
               and (m + 1 == r or (isinstance(spec.layers[m + 1], RouteSpec)
                                   and m not in spec.layers[m + 1].layers))
               for m in layer.layers):
            widths = [spec.out_channels[m] for m in layer.layers]
            plan[r] = tuple(itertools.accumulate(widths[:-1], initial=0))
    return plan


def pack_residual_blocks(folded: Folded, spec: GraphSpec,
                         dtype: torch.dtype = torch.bfloat16) -> Packs:
    """K2 packs (:func:`pack_block_weights`) of every fusible unit."""
    return {
        i: pack_block_weights(folded[f"conv_{i}"]["w"], folded[f"conv_{i}"]["b"],
                              folded[f"conv_{i + 1}"]["w"], folded[f"conv_{i + 1}"]["b"],
                              dtype)
        for i in fusible_residual_blocks(spec)
    }


def widen(x: torch.Tensor) -> torch.Tensor:
    """At least float32: widens bf16 without narrowing a float64 forward."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def pool_padding(kernel: int, stride: int) -> Tuple[int, int, float]:
    """A max pool's padding on each axis: ``(before, after, value)``.  A
    kernel-2/stride-1 pool gets the reference's zero row and column after
    the map (``models.py:50-51``); any other pool ``(k − 1)//2`` of −inf
    on both sides."""
    if kernel == 2 and stride == 1:
        return 0, 1, 0.0
    return (kernel - 1) // 2, (kernel - 1) // 2, float("-inf")


def _maxpool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    before, after, value = pool_padding(kernel, stride)
    if value == 0.0:
        return F.max_pool2d(F.pad(x, (before, after, before, after)), kernel, stride)
    return F.max_pool2d(x, kernel, stride, padding=before)  # pads with −inf itself


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# The walk: every forward runs the graph through :func:`walk`
# ---------------------------------------------------------------------------

#: ``step(i, layer, prev, saved)``: layer ``i``'s value from the previous
#: layer's ``prev`` and the live values ``saved``
Step = Callable[[int, object, object, Dict[int, object]], object]
#: start index → ``(end, fn)``: ``fn(prev, saved)`` is layer ``end``'s value,
#: layers ``start..end`` computed as one (a fused kernel)
Runs = Mapping[int, Tuple[int, Callable[[object, Dict[int, object]], object]]]


def walk(spec: GraphSpec, step: Step, prev, saved: Dict[int, object], *, start: int = 0,
         stop: Optional[int] = None, runs: Optional[Runs] = None):
    """Layers ``start..stop − 1`` of ``spec`` (``stop``: all), from layer
    ``start − 1``'s value ``prev`` and the live values ``saved``; returns
    the last layer's value.

    Each layer is ``step``, or with the rest of its run of ``runs`` one
    call of that run's ``fn``.  A value goes into ``saved`` when a later
    layer reads it and leaves it right after its last reader, so ``saved``
    holds what layers ``stop..`` read when the walk returns (nothing after
    the whole graph).  A run's inner layers are never saved: a run is
    valid only where no layer after it reads them.  The values are the
    caller's: NCHW maps, ``(map, scale)`` pairs of the int8 forwards, one
    map per shard."""
    stop = len(spec.layers) if stop is None else stop
    runs = runs or {}
    freed: List[List[int]] = [[] for _ in spec.layers]  # layers whose last reader is i
    for k, readers in enumerate(spec.consumers):
        if readers:
            freed[max(readers)].append(k)
    i = start
    while i < stop:
        if i in runs:
            end, fn = runs[i]
            prev = fn(prev, saved)
        else:
            end, prev = i, step(i, spec.layers[i], prev, saved)
        if spec.consumers[end]:
            saved[end] = prev
        for j in range(i, end + 1):
            for k in freed[j]:
                saved.pop(k, None)
        i = end + 1
    return prev


def conv(w: torch.Tensor, layer: ConvSpec, x: torch.Tensor, compute_dtype: torch.dtype,
         padding=None) -> torch.Tensor:
    """A conv's raw output: NCHW ``x`` through the OIHW weight ``w``, both in
    ``compute_dtype``, at the layer's stride and its padding (``padding``
    overrides it: a height shard brings its own rows of padding)."""
    return F.conv2d(x, w.to(compute_dtype), stride=layer.stride,
                    padding=layer.pad if padding is None else padding)


def bn_moments_from_sums(s1: torch.Tensor, s2: torch.Tensor, n: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch ``mean`` and biased ``var = max(E[x²] − mean², 0)`` from the
    per-channel ``Σx`` and ``Σx²`` over ``n`` elements."""
    mean, ex2 = s1 / n, s2 / n
    return mean, torch.clamp(ex2 - mean * mean, min=0.0)


def bn_batch_moments(out32: torch.Tensor, reducer: Optional[Callable] = None,
                     groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Train-mode BN statistics ``(mean, var, n)`` of an NCHW f32 conv
    output: this batch's (one pass, ``.mean``), or with ``reducer`` those
    of the global batch its equal shards make up (see :func:`apply`).
    ``groups > 1``: the channels are ``groups`` s2d phase copies of the C
    real ones, phase-major, and the statistics of each real channel reduce
    over its phases too (``n`` counts them)."""
    b, cc, h, w = out32.shape
    v = out32.reshape(b, groups, cc // groups, h, w) if groups > 1 else out32
    dims = (0, 1, 3, 4) if groups > 1 else (0, 2, 3)
    n = b * h * w * groups
    if reducer is None:
        mean = v.mean(dim=dims)
        ex2 = (v * v).mean(dim=dims)
        return mean, torch.clamp(ex2 - mean * mean, min=0.0), n
    s1, s2 = reducer(v.sum(dim=dims), (v * v).sum(dim=dims))
    n = n * reducer.world
    return (*bn_moments_from_sums(s1, s2, n), n)


def bn_batch_moments_matmul(out: torch.Tensor, reducer: Optional[Callable] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`bn_batch_moments` in the ``"matmul"`` form: ``Σx`` and ``Σx²``
    of the NCHW conv output in its own dtype as one product
    (:func:`~..ops.bnstats.channel_sums` over its NHWC rows)."""
    c = out.shape[1]
    s1, s2 = bnstats.channel_sums(nhwc(out).reshape(-1, c))
    n = out.shape[0] * out.shape[2] * out.shape[3]
    if reducer is not None:
        s1, s2 = reducer(s1, s2)
        n = n * reducer.world
    return (*bn_moments_from_sums(s1, s2, n), n)


@torch.no_grad()
def bn_running_stats(params: Mapping[str, torch.Tensor], i: int, mean: torch.Tensor,
                     var: torch.Tensor, n: int) -> StateDict:
    """Conv ``i``'s new running statistics ``(1 − m)·old + m·batch``, the
    variance unbiased (``var·n/(n − 1)``), detached."""
    p = _bn_key(i)
    unbiased = var * (n / max(n - 1, 1))
    return {f"{p}.running_mean": (1 - BN_MOMENTUM) * params[f"{p}.running_mean"]
            + BN_MOMENTUM * mean,
            f"{p}.running_var": (1 - BN_MOMENTUM) * params[f"{p}.running_var"]
            + BN_MOMENTUM * unbiased}


def bn_running_moments(params: Mapping[str, torch.Tensor], i: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv ``i``'s running ``(mean, var)`` in f32: eval-mode BN."""
    p = _bn_key(i)
    return (params[f"{p}.running_mean"].to(torch.float32),
            params[f"{p}.running_var"].to(torch.float32))


def bn_normalize(params: Mapping[str, torch.Tensor], i: int, out32: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, compute_dtype: torch.dtype,
                 groups: int = 1) -> torch.Tensor:
    """``(x − mean)·γ·rsqrt(var + ε) + β`` in ``out32``'s dtype (f32, or
    f64 in a float64 forward), rounded to ``compute_dtype`` (``groups``: the
    per-channel vectors tiled over the s2d phases)."""
    wide = out32.dtype
    p = _bn_key(i)
    inv = torch.rsqrt(var + BN_EPS)
    g = params[f"{p}.weight"].to(wide) * inv
    beta = params[f"{p}.bias"].to(wide)
    if groups > 1:
        mean, g, beta = mean.repeat(groups), g.repeat(groups), beta.repeat(groups)
    return ((out32 - mean[None, :, None, None]) * g[None, :, None, None]
            + beta[None, :, None, None]).to(compute_dtype)


def conv_bias(params: Mapping[str, torch.Tensor], i: int, out: torch.Tensor,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """A conv without BN (a head conv) adds its bias in ``compute_dtype``."""
    return out + params[f"{_conv_key(i)}.bias"].to(compute_dtype)[None, :, None, None]


def activate(layer: ConvSpec, out: torch.Tensor) -> torch.Tensor:
    """The conv's activation on ``out``: the leaky in ``out``'s dtype, Mish
    in at least float32 rounded once to it, or nothing (linear)."""
    if layer.activation == "leaky":
        return _leaky(out)
    if layer.activation == "mish":
        return mish_wide(out)
    return out


def refuse_grid_sensitive(spec: GraphSpec, path: str) -> None:
    """``ValueError`` if the graph has YOLOv4's parts, Mish convs or heads
    with ``scale_x_y`` ≠ 1, which ``path`` would compute wrongly.  The paths
    built for YOLOv3's leaky convs and plain heads alone call it: the int8
    executors (``int8_early``, ``int8_full``) and the s2d stems; the float
    ``Detector``, the train step and the ``Trainer`` take both graphs."""
    mish = [l.index for l in spec.layers
            if isinstance(l, ConvSpec) and l.activation == "mish"]
    scaled = [f"{l.index} ({l.scale_x_y})" for l in spec.layers
              if isinstance(l, YoloSpec) and l.scale_x_y != 1.0]
    parts = ([f"{len(mish)} Mish convs (first {mish[0]})"] if mish else []) + (
        [f"yolo layers with scale_x_y != 1: {', '.join(scaled)}"] if scaled else [])
    if parts:
        raise ValueError(f"{path} takes YOLOv3's leaky convs and heads only; this graph has "
                         + "; ".join(parts))


def conv_layer(params: Mapping[str, torch.Tensor], i: int, layer: ConvSpec, x: torch.Tensor,
               compute_dtype: torch.dtype, *, train: bool = False,
               reducer: Optional[Callable] = None, new_stats: Optional[StateDict] = None,
               bn_form: str = "reduce") -> torch.Tensor:
    """Conv ``i`` with its BN (eval: running statistics; train: batch
    statistics, its new running statistics written into ``new_stats``) or
    its bias, and its activation, on the NCHW map ``x``."""
    out = conv(params[f"{_conv_key(i)}.weight"], layer, x, compute_dtype)
    if not layer.batch_normalize:
        return activate(layer, conv_bias(params, i, out, compute_dtype))
    return activate(layer, _bn(params, i, out, compute_dtype, train, reducer, new_stats,
                               bn_form=bn_form))


def _bn(params: Mapping[str, torch.Tensor], i: int, out: torch.Tensor,
        compute_dtype: torch.dtype, train: bool, reducer: Optional[Callable],
        new_stats: Optional[StateDict], groups: int = 1, bn_form: str = "reduce"
        ) -> torch.Tensor:
    """BN ``i`` of the NCHW conv output ``out`` (see :func:`conv_layer`);
    ``groups`` as :func:`bn_batch_moments` takes it.  The ``"matmul"`` form
    (train mode, ``groups == 1``) takes its sums and its normalize's
    backward sums as products (:mod:`..ops.bnstats`)."""
    if train and bn_form == "matmul" and groups == 1:
        mean, var, n = bn_batch_moments_matmul(out, reducer)
        new_stats.update(bn_running_stats(params, i, mean, var, n))
        p = _bn_key(i)
        f32 = torch.float32
        return bnstats.bn_normalize(out, mean, torch.rsqrt(var + BN_EPS),
                                    params[f"{p}.weight"].to(f32), params[f"{p}.bias"].to(f32))
    out32 = widen(out)
    if train:
        mean, var, n = bn_batch_moments(out32, reducer, groups)
        new_stats.update(bn_running_stats(params, i, mean, var, n))
    else:
        mean, var = bn_running_moments(params, i)
    return bn_normalize(params, i, out32, mean, var, compute_dtype, groups)


def folded_conv(folded: Folded, i: int, layer: ConvSpec, x: torch.Tensor,
                compute_dtype: torch.dtype, padding=None,
                into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv ``i`` over BN-folded params: conv, bias in ``compute_dtype``,
    activation (``padding`` as :func:`conv` takes it).  On the card the bias
    and the activation are one in-place pass over the conv's output
    (:func:`~..kernels.bias_leaky.bias_leaky`, or for a Mish conv
    :func:`~..kernels.bias_leaky.bias_mish`).  ``into`` (a Mish conv only):
    the channel slice of a route's map that takes the values instead, and
    is returned.

    ``conv`` and ``bias_mish`` are looked up here at each call, so that a
    stand-in set on this module reaches every conv: the benchmark's planted
    faults are such stand-ins.  A stand-in ``bias_mish`` takes ``(out, b)``
    alone, so its result is copied into ``into``."""
    out = conv(folded[f"conv_{i}"]["w"], layer, x, compute_dtype, padding)
    b = folded[f"conv_{i}"]["b"]
    if layer.activation != "mish":
        return bias_leaky(out, b, layer.activation == "leaky")
    if into is None:
        return bias_mish(out, b)
    if bias_mish is not _bias_mish:
        return into.copy_(bias_mish(out, b))
    return bias_mish(out, b, into)


def apply(params: Mapping[str, torch.Tensor], spec: GraphSpec, x: torch.Tensor, *,
          compute_dtype: torch.dtype = torch.float32, train: bool = False,
          reducer: Optional[Callable] = None, s2d_stem: bool = False,
          input_layout: str = "nhwc", bn_form: Optional[str] = None):
    """Forward over *unfolded* parameters (a state dict in the reference
    layout, BN running statistics included); returns the f32 NHWC map at
    each yolo layer, and with ``train=True`` the pair ``(head_maps,
    new_stats)``.

    Each conv runs in ``compute_dtype`` (cast explicitly, no autocast); BN
    normalises in f32 and rounds back, and head convs add their bias in
    ``compute_dtype``, as the reference (``darknet.py:155-318``).

    Eval mode normalises with the running statistics and ``rsqrt(var + ε)``.
    Train mode: one-pass f32 batch statistics ``mean`` and ``E[x²]``,
    ``var = max(E[x²] − mean², 0)`` (biased) to normalise, and the running
    statistics ``(1 − m)·old + m·batch`` with ``m = BN_MOMENTUM`` and the
    unbiased ``var·n/(n − 1)``.  ``new_stats`` maps each ``…running_mean``
    and ``…running_var`` key to its new (detached) value; gradients flow
    through the batch statistics, as autodiff of the reference does.

    ``bn_form`` (train mode; ``None`` reads the module's ``BN_FORM``, from
    ``AMYOLO_BN_FORM``): ``"reduce"`` sums with reductions; ``"matmul"``
    takes ``Σx``, ``Σx²`` and the normalize's backward sums ``Σdy``,
    ``Σdy·x`` as products with a ones row (:mod:`..ops.bnstats`).  Same
    function, other summation order.  Another value raises
    (:func:`resolve_bn_form`), where the reference reduces.

    ``input_layout="planar"``: ``x`` is a (B, 3, H, W) image (contiguous
    NCHW, the planar training pipeline's layout) instead of NHWC.

    ``s2d_stem=True`` computes layers 0-1 (3x3/s1 conv into the 3x3/s2
    conv, both with BN and leaky) on the space-to-depth grid, the weights
    relabelled inside the forward (:func:`_s2d_relabel`), so gradients come
    back in the standard 3x3 parameterization; the BN statistics of layer
    0 reduce over its four phases too.  Same function up to summation
    order.

    ``reducer`` (train mode) makes the batch statistics those of a global
    batch split into shards (sync-BN, as the reference's data-parallel
    step computes them): each BN hands it its shard's per-channel ``Σx``
    and ``Σx²`` and takes back their sums over the shards; the count is the
    shard's times ``reducer.world`` (the shards are equal).  Without it the
    statistics are this batch's, computed exactly as before.  Unequal
    shards (the height shards of ``parallel/spatial.py``) call the
    per-layer functions above with their own global count.
    """
    bn_form = resolve_bn_form(bn_form)
    planar = input_layout == "planar"
    head_maps: List[torch.Tensor] = []
    new_stats: StateDict = {}

    def step(i, layer, prev, saved):
        if isinstance(layer, ConvSpec):
            return conv_layer(params, i, layer, prev, compute_dtype, train=train,
                              reducer=reducer, new_stats=new_stats, bn_form=bn_form)
        return plain_layer(layer, prev, saved, head_maps)

    x = x.to(compute_dtype)
    if s2d_stem:
        walk(spec, step, x, {}, runs={0: (1, lambda x, _: _s2d_train_stem(
            params, spec, x, compute_dtype, train, reducer, new_stats, planar))})
    else:
        walk(spec, step, channels_last(x if planar else nchw(x)), {})
    return (head_maps, new_stats) if train else head_maps


def plain_layer(layer, prev: torch.Tensor, saved: Dict[int, torch.Tensor],
                head_maps: List[torch.Tensor]) -> torch.Tensor:
    """A layer other than a conv, on an NCHW float map."""
    if isinstance(layer, MaxPoolSpec):
        return _maxpool(prev, layer.kernel, layer.stride)
    if isinstance(layer, UpsampleSpec):
        return F.interpolate(prev, scale_factor=layer.factor, mode="nearest")
    if isinstance(layer, RouteSpec):
        return channels_last(torch.cat([saved[s] if s in saved else prev
                                        for s in layer.layers], dim=1))
    if isinstance(layer, ShortcutSpec):
        return prev + saved[layer.from_index]
    if isinstance(layer, YoloSpec):
        head_maps.append(nhwc(widen(prev)).contiguous())
        return prev
    raise TypeError(f"unknown layer spec {layer!r}")  # pragma: no cover


def apply_folded(folded: Folded, spec: GraphSpec, x: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 packs: Optional[Packs] = None,
                 block_fn: Callable[..., torch.Tensor] = fused_residual_block,
                 s2d_stem: Optional[Folded] = None,
                 spp: Optional[Mapping[int, SppBlock]] = None,
                 routes: Optional[Mapping[int, Tuple[int, ...]]] = None) -> List[torch.Tensor]:
    """Inference forward over BN-folded params; returns the f32 NHWC map at
    each yolo layer.

    ``x``: (B, H, W, 3) image in [0, 1], any float dtype (cast to
    ``compute_dtype`` on entry).  ``packs`` (:func:`pack_residual_blocks`)
    sends each packed residual unit through ``block_fn`` — K2 by default;
    its plain version to compare with.  Without packs every layer runs
    unfused.  ``s2d_stem`` (:func:`make_s2d_stem`) computes layers 0-1 on
    the space-to-depth grid (:func:`s2d_stem_forward`); the residual units
    from layer 2 on are unchanged.  ``spp`` (:func:`spp_blocks`) sends each
    SPP block through :func:`~..kernels.spp_pool.spp_pool`; without it the
    pools and their route run layer by layer.  Each of these is a run of
    :func:`walk`.  ``routes`` (:func:`route_slices`) joins each of its
    routes in place: its members' epilogues write into the route's map, and
    the route copies nothing; without it every route is a ``torch.cat``.
    """
    x = x.to(compute_dtype)
    head_maps: List[torch.Tensor] = []
    runs = {**_spp_runs(spp), **_residual_runs(packs, block_fn)}
    if s2d_stem is None:
        prev = channels_last(nchw(x))
    else:
        runs[0] = (1, lambda x, _: s2d_stem_forward(s2d_stem, x, compute_dtype))
        prev = x
    walk(spec, _folded_step(folded, compute_dtype, head_maps, spec, routes), prev, {},
         runs=runs)
    return head_maps


def _folded_step(folded: Folded, compute_dtype: torch.dtype, head_maps: List[torch.Tensor],
                 spec: Optional[GraphSpec] = None,
                 routes: Optional[Mapping[int, Tuple[int, ...]]] = None) -> Step:
    """A layer of the folded forward on an NCHW map: :func:`folded_conv`
    or :func:`plain_layer`.  A member of one of ``routes`` (the
    :func:`route_slices` of ``spec``) is its slice of the route's map,
    allocated at the route's first member to run and returned whole at the
    route.  While such a map is held, a shortcut adds into the conv output
    before it where no other layer reads that (the same sums), so that the
    held map does not raise the forward's peak by a copy more."""
    routes = routes or {}
    slot = {m: (r, off) for r, offs in routes.items()
            for m, off in zip(spec.layers[r].layers, offs)}
    sole = {l.index for l in spec.layers if isinstance(l, ShortcutSpec)
            and isinstance(spec.layers[l.index - 1], ConvSpec)
            and spec.consumers[l.index - 1] == {l.index}} if routes else set()
    maps: Dict[int, torch.Tensor] = {}

    def step(i, layer, prev, saved):
        if i in slot:
            r, off = slot[i]
            if r not in maps:
                b, _, h, w = prev.shape
                h, w = ((n + 2 * layer.pad - layer.kernel) // layer.stride + 1 for n in (h, w))
                maps[r] = torch.empty((b, spec.out_channels[r], h, w), dtype=compute_dtype,
                                      device=prev.device, memory_format=torch.channels_last)
            return folded_conv(folded, i, layer, prev, compute_dtype,
                               into=maps[r][:, off:off + layer.out_ch])
        if i in maps:
            return maps.pop(i)
        if maps and i in sole:
            return prev.add_(saved[layer.from_index])
        if isinstance(layer, ConvSpec):
            return folded_conv(folded, i, layer, prev, compute_dtype)
        return plain_layer(layer, prev, saved, head_maps)
    return step


def _residual_runs(packs: Optional[Packs], block_fn: Callable[..., torch.Tensor]) -> Runs:
    """Each packed residual unit as a run from its 1x1 conv to its
    shortcut: ``block_fn`` on the NHWC view of the map."""
    return {i: (i + 2, functools.partial(_residual_unit, block_fn, pack))
            for i, pack in (packs or {}).items()}


def _residual_unit(block_fn, pack, prev: torch.Tensor, saved) -> torch.Tensor:
    return nchw(block_fn(nhwc(channels_last(prev)), *pack))


def _spp_runs(spp: Optional[Mapping[int, SppBlock]]) -> Runs:
    """Each SPP block as a run from its first pool to its route: one
    :func:`~..kernels.spp_pool.spp_pool`."""
    return {i: (block.route, functools.partial(_spp_block, block))
            for i, block in (spp or {}).items()}


def _spp_block(block: SppBlock, prev: torch.Tensor, saved) -> torch.Tensor:
    return spp_pool(prev, block.kernels, block.order)


# ---------------------------------------------------------------------------
# Space-to-depth stem and downsample (reference ``darknet.py:492-765``)
#
# Layers 0-1 of YOLOv3 (3x3/s1 over the RGB image into 3x3/s2) are the same
# function as, on the space-to-depth grid (x (2H, 2W, C) → (H, W, 4C),
# channel (ph·2 + pw)·C + c):
#   conv_a  3x3/s1, 4·Cin → 4·C0: conv 0 with its outputs phase-encoded,
#           a[(ph·2+pw)·C0 + o, H, W] = conv0(x)[o, 2H+ph, 2W+pw];
#   conv_b  2x2/s1 with one row and column of zero padding at the top and
#           left, 4·C0 → C1: conv 1, whose 3x3/s2 taps read s2d rows H−1
#           and H across the phases.
# The relabelled weights hold each weight once per phase or zero, so the
# products are the same and only the order of the sums differs; the int8
# conv_b reuses conv 1's integer weights, whose int32 sums are exact.
# Weights here are OIHW (the port's layout), activations NCHW in
# channels_last memory; the s2d channel order is the reference's.
# ---------------------------------------------------------------------------

def _check_s2d_spec(spec: GraphSpec) -> None:
    """Raise ``ValueError`` unless layers 0-1 are the YOLOv3 stem: conv
    3x3/s1 leaky into conv 3x3/s2 leaky, layer 0 read by layer 1 only, in a
    graph without YOLOv4's parts."""
    refuse_grid_sensitive(spec, "the s2d stem")
    l0, l1 = spec.layers[0], spec.layers[1]
    ok = (isinstance(l0, ConvSpec) and l0.kernel == 3 and l0.stride == 1
          and l0.activation == "leaky"
          and isinstance(l1, ConvSpec) and l1.kernel == 3 and l1.stride == 2
          and l1.activation == "leaky"
          and not spec.consumers[0])
    if not ok:
        raise ValueError(
            "s2d stem needs the YOLOv3 stem shape: conv 3x3/s1 leaky into "
            "conv 3x3/s2 leaky with layer 0 consumed only by layer 1")


def s2d_train_stem_qualifies(spec: GraphSpec) -> bool:
    """Whether ``apply(s2d_stem=True)`` takes this spec: the stem shape and
    BN on layers 0 and 1 (the reference ``Trainer``'s automatic choice,
    ``training.py:165-173``)."""
    try:
        _check_s2d_spec(spec)
    except ValueError:
        return False
    return bool(spec.layers[0].batch_normalize and spec.layers[1].batch_normalize)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, 2H, 2W, C) → (B, H, W, 4C), channel (ph·2 + pw)·C + c."""
    b, h2, w2, c = x.shape
    x = x.reshape(b, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2 // 2, w2 // 2, 4 * c)


def _space_to_depth_planar(x: torch.Tensor) -> torch.Tensor:
    """Planar (B, C, 2H, 2W) → NHWC (B, H, W, 4C) in :func:`_space_to_depth`'s
    channel order, in one permute (the NHWC image is never made)."""
    b, c, h2, w2 = x.shape
    x = x.reshape(b, c, h2 // 2, 2, w2 // 2, 2).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, h2 // 2, w2 // 2, 4 * c)


def _s2d_transform_conv_a(w0: np.ndarray, b0: Optional[np.ndarray] = None):
    """3x3/s1 OIHW (C0, Cin) → 3x3/s1 on the s2d grid (4·C0, 4·Cin), zero
    filled, in ``w0``'s dtype; and the bias tiled over the four phases."""
    c0, cin = w0.shape[:2]
    wa = np.zeros((4 * c0, 4 * cin, 3, 3), w0.dtype)
    for ph in range(2):
        for pw in range(2):
            for dh in range(3):
                for dw in range(3):
                    qh, rh = divmod(ph + dh - 1, 2)
                    qw, rw = divmod(pw + dw - 1, 2)
                    o, i = (ph * 2 + pw) * c0, (rh * 2 + rw) * cin
                    wa[o:o + c0, i:i + cin, qh + 1, qw + 1] = w0[:, :, dh, dw]
    return wa, (None if b0 is None else np.tile(np.asarray(b0, np.float32), 4))


def _s2d_transform_conv_b(w1: np.ndarray) -> np.ndarray:
    """3x3/s2 OIHW (C1, C0) → 2x2/s1 with top/left padding over the phase-
    encoded channels (C1, 4·C0), zero filled, in ``w1``'s dtype (float or
    already-quantized int8: the zeros add exactly nothing)."""
    c1, c0 = w1.shape[:2]
    wb = np.zeros((c1, 4 * c0, 2, 2), w1.dtype)
    for kh in range(2):
        for kw in range(2):
            for rh in range(2):
                for rw in range(2):
                    dh, dw = 2 * kh + rh - 1, 2 * kw + rw - 1
                    if 0 <= dh < 3 and 0 <= dw < 3:
                        i = (rh * 2 + rw) * c0
                        wb[:, i:i + c0, kh, kw] = w1[:, :, dh, dw]
    return wb


def make_s2d_stem(folded: Folded, spec: GraphSpec) -> Folded:
    """The s2d stem of the float path from folded conv 0 and conv 1:
    ``{"wa", "ba", "wb", "bb"}``, f32 on the CPU."""
    _check_s2d_spec(spec)
    wa, ba = _s2d_transform_conv_a(_np32(folded["conv_0"]["w"]), _np32(folded["conv_0"]["b"]))
    wb = _s2d_transform_conv_b(_np32(folded["conv_1"]["w"]))
    return {"wa": torch.from_numpy(wa), "ba": torch.from_numpy(ba),
            "wb": torch.from_numpy(wb), "bb": torch.from_numpy(_np32(folded["conv_1"]["b"]))}


def _conv_b(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """2x2/s1 conv of an NCHW map with one zero row on top and one zero
    column on the left (the s2d image of conv 1's symmetric pad 1)."""
    return F.conv2d(channels_last(F.pad(x, (1, 0, 1, 0))), w)


def s2d_stem_forward(stem: Folded, x: torch.Tensor, compute_dtype: torch.dtype
                     ) -> torch.Tensor:
    """Layers 0-1 of the folded path on the s2d grid: NHWC ``x`` (B, S, S,
    Cin) → layer 1's NCHW output (B, C1, S/2, S/2), channels_last.  Rounded
    where the reference rounds: each conv's f32 sum to ``compute_dtype``,
    then the bias in ``compute_dtype``, then leaky."""
    xs = channels_last(nchw(_space_to_depth(x.to(compute_dtype))))
    a = F.conv2d(xs, stem["wa"].to(compute_dtype), padding=1)
    a = _leaky(a + stem["ba"].to(compute_dtype)[None, :, None, None])
    b = _conv_b(a, stem["wb"].to(compute_dtype))
    return _leaky(b + stem["bb"].to(compute_dtype)[None, :, None, None])


# -- the training stem: the relabel inside the forward ----------------------
#
# Each relabelled weight is zero or one element of the 3x3 kernel, so the
# relabel is a gather from the flat kernel plus one appended zero; autograd
# scatter-adds its gradient back onto the 3x3 kernel, and the optimizer
# keeps the reference parameterization.

def _gather_indices(transform, shape) -> np.ndarray:
    """Flat-index map of ``transform`` (one of the two above) over a weight
    of ``shape``: the source element of each relabelled position, or
    ``prod(shape)`` (the appended zero) where it is zero filled."""
    n = int(np.prod(shape))
    idx = transform(np.arange(1, n + 1, dtype=np.int64).reshape(shape))
    idx = (idx[0] if isinstance(idx, tuple) else idx) - 1
    return np.where(idx < 0, n, idx)


@functools.lru_cache(maxsize=None)
def _s2d_gather_indices_a(cin: int, c0: int, device: str = "cpu") -> torch.Tensor:
    """Gather map of conv_a, (4·C0, 4·Cin, 3, 3) into conv 0's flat OIHW
    weight."""
    return torch.from_numpy(_gather_indices(_s2d_transform_conv_a, (c0, cin, 3, 3))).to(device)


@functools.lru_cache(maxsize=None)
def _s2d_gather_indices_b(c0: int, c1: int, device: str = "cpu") -> torch.Tensor:
    """Gather map of conv_b, (C1, 4·C0, 2, 2) into conv 1's flat OIHW
    weight."""
    return torch.from_numpy(_gather_indices(_s2d_transform_conv_b, (c1, c0, 3, 3))).to(device)


def _s2d_relabel(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable zero-filled relabel of ``w`` by a gather map."""
    return torch.cat([w.reshape(-1), w.new_zeros(1)])[idx]


def _s2d_train_stem(params: Mapping[str, torch.Tensor], spec: GraphSpec, x: torch.Tensor,
                    compute_dtype: torch.dtype, train: bool, reducer: Optional[Callable],
                    new_stats: StateDict, planar: bool) -> torch.Tensor:
    """Layers 0-1 of :func:`apply` on the s2d grid (reference ``darknet.py:
    215-240``): NHWC or planar ``x`` → layer 1's NCHW output."""
    _check_s2d_spec(spec)
    l0: ConvSpec = spec.layers[0]  # type: ignore[assignment]
    l1: ConvSpec = spec.layers[1]  # type: ignore[assignment]
    if not (l0.batch_normalize and l1.batch_normalize):
        raise ValueError("s2d training stem requires BN on layers 0-1")
    dev = str(x.device)
    wa = _s2d_relabel(params[f"{_conv_key(0)}.weight"].to(compute_dtype),
                      _s2d_gather_indices_a(l0.in_ch, l0.out_ch, dev))
    xs = _space_to_depth_planar(x) if planar else _space_to_depth(x)
    a = F.conv2d(channels_last(nchw(xs)), wa, padding=1)
    a = _leaky(_bn(params, 0, a, compute_dtype, train, reducer, new_stats, groups=4))
    wb = _s2d_relabel(params[f"{_conv_key(1)}.weight"].to(compute_dtype),
                      _s2d_gather_indices_b(l1.in_ch, l1.out_ch, dev))
    out = _conv_b(a, wb)
    return _leaky(_bn(params, 1, out, compute_dtype, train, reducer, new_stats))


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
    prev = channels_last(nchw(x.to(f32)))
    stats = {"in": _act_stat(prev, percentile)}

    def step(i, layer, prev, saved):
        if isinstance(layer, ConvSpec):
            out = F.conv2d(prev, folded[f"conv_{i}"]["w"].to(f32),
                           stride=layer.stride, padding=layer.pad)
            out = out + folded[f"conv_{i}"]["b"].to(f32)[None, :, None, None]
            if layer.activation == "leaky":
                out = _leaky(out)
        else:
            out = plain_layer(layer, prev, saved, [])
        stats[str(i)] = _act_stat(out, percentile)
        return out

    with no_tf32():
        walk(spec, step, prev, {}, stop=upto)
    keys = list(stats)
    values = torch.stack([stats[k].to(f32) for k in keys]).cpu().tolist()
    return {k: float(v) / 127.0 + 1e-12 for k, v in zip(keys, values)}


def calibrate_act_scales(folded: Folded, spec: GraphSpec, x: torch.Tensor, upto: int,
                         percentile: float = 100.0) -> Dict[str, float]:
    """Static activation scales of the ``int8_early`` region from a sample
    batch ``x`` (NHWC, [0, 1]): an f32 forward, TF32 off."""
    refuse_grid_sensitive(spec, "int8_early")
    for layer in spec.layers[:upto]:
        if isinstance(layer, (RouteSpec, YoloSpec)):
            raise TypeError(f"int8 region cannot contain {layer!r}")
    return _calibrate(folded, spec, x, upto, percentile)


def calibrate_act_scales_full(folded: Folded, spec: GraphSpec, x: torch.Tensor,
                              percentile: float = 100.0) -> Dict[str, float]:
    """Static activation scales of every layer's output (``int8_full``)."""
    refuse_grid_sensitive(spec, "int8_full")
    return _calibrate(folded, spec, x, len(spec.layers), percentile)


def _dequant(q: torch.Tensor, s: float) -> torch.Tensor:
    return q.to(torch.float32) * s


def _int8_conv(qp: Mapping[str, torch.Tensor], xq: torch.Tensor, s_in: float,
               layer: ConvSpec, int32_accum: bool, s2d_wq: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Quantized conv + f32 epilogue (:func:`_int8_epilogue`): NHWC int8 in,
    f32 out.  ``s2d_wq`` (:func:`make_s2d_down_int8`) runs a 3x3/s2 conv as
    the 2x2 conv_b over the s2d grid of ``xq``: the same integer sums."""
    if s2d_wq is not None:
        acc = q8.conv_int8(_space_to_depth(xq), s2d_wq, 1, (1, 0))
    else:
        acc = q8.conv_int8(xq, qp["wq"], layer.stride, layer.pad)
    return _int8_epilogue(acc, qp, s_in, layer, int32_accum)


def _int8_epilogue(acc: torch.Tensor, qp: Mapping[str, torch.Tensor], s_in: float,
                   layer: ConvSpec, int32_accum: bool) -> torch.Tensor:
    """``acc·(s_in·ws) + b`` in f32 (and leaky) of the exact int32 sums
    ``acc``, rounded to bf16 first unless ``int32_accum``."""
    if not int32_accum:
        acc = acc.to(torch.bfloat16)
    y = acc.to(torch.float32) * (qp["ws"] * s_in) + qp["b"]
    return _leaky(y) if layer.activation == "leaky" else y


def _bf16_conv(folded: Folded, i: int, layer: ConvSpec, xf: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """A conv the int8 paths keep in ``compute_dtype``: NHWC ``xf`` (already
    in ``compute_dtype``) → f32 NHWC, the sum taken in f32 over the rounded
    values and kept in f32, plus the f32 bias (and leaky)."""
    y = _wide_conv(folded[f"conv_{i}"]["w"], folded[f"conv_{i}"]["b"], xf, compute_dtype,
                   layer.stride, layer.pad)
    return _leaky(y) if layer.activation == "leaky" else y


def _wide_conv(w: torch.Tensor, b: torch.Tensor, xf: torch.Tensor,
               compute_dtype: torch.dtype, stride: int, pad: int) -> torch.Tensor:
    """NHWC ``xf`` through the OIHW ``w`` rounded to ``compute_dtype``, the
    sum in f32, plus the f32 bias: f32 NHWC."""
    w = w.to(compute_dtype).to(torch.float32)
    y = nhwc(F.conv2d(nchw(xf.to(torch.float32)), w, stride=stride, padding=pad))
    return y + b.to(torch.float32)


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
    sc = q8.inverse_scales(act_scales, x.device)

    def step(i, layer, prev, saved):  # (int8 map, scale) pairs
        prev_q, prev_s = prev
        if isinstance(layer, UpsampleSpec):
            return q8.upsample_int8(prev_q, layer.factor), prev_s
        if isinstance(layer, ConvSpec):
            if int8_compute:
                y = _int8_conv(qparams[f"conv_{i}"], prev_q, prev_s, layer, False)
            else:
                y = _bf16_conv(folded, i, layer, _in_dtype(prev_q, prev_s, compute_dtype),
                               compute_dtype)
        elif isinstance(layer, ShortcutSpec):
            aq, as_ = saved[layer.from_index]
            y = _dequant(prev_q, prev_s) + _dequant(aq, as_)
        elif isinstance(layer, MaxPoolSpec):
            y = nhwc(_maxpool(nchw(_dequant(prev_q, prev_s)), layer.kernel, layer.stride))
        else:  # pragma: no cover
            raise TypeError(f"int8 region cannot contain {layer!r}")
        return q8.quant(y, sc[str(i)]), act_scales[str(i)]

    saved_q: Dict[int, Tuple[torch.Tensor, float]] = {}
    prev_q, prev_s = walk(spec, step, (q8.quant(x, sc["in"]), act_scales["in"]), saved_q,
                          stop=upto)

    # boundary: dequantize into compute_dtype and run the standard folded path
    prev = channels_last(nchw(_in_dtype(prev_q, prev_s, compute_dtype)))
    saved = {k: channels_last(nchw(_in_dtype(q, s, compute_dtype)))
             for k, (q, s) in saved_q.items()}
    head_maps: List[torch.Tensor] = []
    walk(spec, _folded_step(folded, compute_dtype, head_maps), prev, saved, start=upto)
    return head_maps


def make_s2d_stem_int8(folded: Folded, qparams: QParams, spec: GraphSpec) -> QParams:
    """The s2d stem of ``int8_full``: conv_a in ``compute_dtype`` from folded
    conv 0, conv_b with conv 1's int8 weights relabelled (the same integer
    sums), conv 1's scales and bias: ``{"wa", "ba", "wbq", "wbs", "bb"}``
    on the CPU."""
    _check_s2d_spec(spec)
    if "conv_1" not in qparams:
        raise ValueError("conv_1 is not quantized in these qparams")
    wa, ba = _s2d_transform_conv_a(_np32(folded["conv_0"]["w"]), _np32(folded["conv_0"]["b"]))
    q1 = qparams["conv_1"]
    wbq = _s2d_transform_conv_b(q1["wq"].cpu().numpy())
    return {"wa": torch.from_numpy(wa), "ba": torch.from_numpy(ba),
            "wbq": torch.from_numpy(wbq), "wbs": q1["ws"].cpu(), "bb": q1["b"].cpu()}


def make_s2d_down_int8(qparams: QParams, spec: GraphSpec, max_in_ch: int = 64
                       ) -> Dict[int, torch.Tensor]:
    """``{i: relabelled int8 weight}`` of every quantized 3x3/s2 pad-1 conv
    other than conv 1 with at most ``max_in_ch`` input channels (conv 5,
    64 → 128 at 208², in YOLOv3), to run as conv_b on its input's s2d grid
    (reference ``darknet.py:636-661``).  Scales and biases stay in
    ``qparams``."""
    out: Dict[int, torch.Tensor] = {}
    for i, layer in enumerate(spec.layers):
        if (isinstance(layer, ConvSpec) and layer.kernel == 3 and layer.stride == 2
                and layer.pad == 1 and i != 1 and layer.in_ch <= max_in_ch
                and f"conv_{i}" in qparams):
            out[i] = torch.from_numpy(
                _s2d_transform_conv_b(qparams[f"conv_{i}"]["wq"].cpu().numpy()))
    return out


def apply_folded_int8_full(folded: Folded, qparams: QParams,
                           act_scales: Mapping[str, float], spec: GraphSpec,
                           x: torch.Tensor, *, compute_dtype: torch.dtype = torch.bfloat16,
                           s2d_stem: Optional[QParams] = None,
                           s2d_downs: Optional[Mapping[int, torch.Tensor]] = None,
                           int32_accum_max_hw: int = 0) -> List[torch.Tensor]:
    """``int8_full``: every activation int8 at the static ``act_scales``,
    the convs of :func:`int8_full_conv_indices` int8 (exact int32 sums when
    the output map is at most ``int32_accum_max_hw`` wide, bf16-rounded
    above), the stem and the head convs in ``compute_dtype``.  Routes
    rescale each branch to the route's scale; shortcuts dequantize, add
    and requantize; max pool and upsample stay int8.  ``x`` is the f32 NHWC
    input in [0, 1]; returns the f32 NHWC head maps.

    ``s2d_stem`` (:func:`make_s2d_stem_int8`) runs layers 0-1 on the s2d
    grid: conv_a in ``compute_dtype`` with an f32 sum, quantized at conv
    0's scale, the int8 conv_b (bf16-rounded sum, as the reference), then
    quantized at conv 1's.  ``s2d_downs`` (:func:`make_s2d_down_int8`) runs
    those convs on their input's s2d grid, with the same integer sums."""
    x = x.to(torch.float32)
    sc = q8.inverse_scales(act_scales, x.device)
    quantized = int8_full_conv_indices(spec)
    head_maps: List[torch.Tensor] = []

    # (map, scale) pairs; scale None marks a float map (the raw input, or a
    # head conv's output)
    def step(i, layer, prev, saved):
        prev_q, prev_s = prev
        if isinstance(layer, ConvSpec):
            if i in quantized:
                if prev_s is None:  # raw input into a quantized conv
                    prev_q, prev_s = q8.quant(prev_q, sc["in"]), act_scales["in"]
                out_hw = prev_q.shape[1] // layer.stride
                y = _int8_conv(qparams[f"conv_{i}"], prev_q, prev_s, layer,
                               out_hw <= int32_accum_max_hw,
                               s2d_downs.get(i) if s2d_downs else None)
                return q8.quant(y, sc[str(i)]), act_scales[str(i)]
            y = _bf16_conv(folded, i, layer, _in_dtype(prev_q, prev_s, compute_dtype),
                           compute_dtype)
            if layer.activation == "leaky":
                return q8.quant(y, sc[str(i)]), act_scales[str(i)]
            return y, None  # the f32 map feeds the decode
        if isinstance(layer, ShortcutSpec):
            aq, as_ = saved[layer.from_index]
            y = _dequant(prev_q, prev_s) + _dequant(aq, as_)
            return q8.quant(y, sc[str(i)]), act_scales[str(i)]
        if isinstance(layer, MaxPoolSpec):
            return q8.maxpool_int8(prev_q, layer.kernel, layer.stride), prev_s
        if isinstance(layer, UpsampleSpec):
            return q8.upsample_int8(prev_q, layer.factor), prev_s
        if isinstance(layer, RouteSpec):
            parts = []
            for k in layer.layers:
                q, s = saved[k] if k in saved else (prev_q, prev_s)
                parts.append(q8.quant(q if s is None else _dequant(q, s), sc[str(i)]))
            return torch.cat(parts, dim=-1), act_scales[str(i)]
        if isinstance(layer, YoloSpec):
            if prev_s is not None:
                raise ValueError(f"yolo layer {i} must read a linear head conv")
            head_maps.append(prev_q.contiguous())
            return prev_q, None
        raise TypeError(f"unknown layer spec {layer!r}")  # pragma: no cover

    def stem(prev, _):  # layers 0-1 on the s2d grid
        a = _wide_conv(s2d_stem["wa"], s2d_stem["ba"],
                       _space_to_depth(prev[0].to(compute_dtype)), compute_dtype, 1, 1)
        aq = q8.quant(_leaky(a), sc["0"])
        y = _int8_epilogue(q8.conv_int8(aq, s2d_stem["wbq"], 1, (1, 0)),
                           {"ws": s2d_stem["wbs"], "b": s2d_stem["bb"]}, act_scales["0"],
                           spec.layers[1], False)
        return q8.quant(y, sc["1"]), act_scales["1"]

    walk(spec, step, (x, None), {}, runs=None if s2d_stem is None else {0: (1, stem)})
    return head_maps


__all__ = ["init_params", "apply", "fold_batchnorm", "fusible_residual_blocks",
           "pack_residual_blocks", "apply_folded", "int8_region",
           "quantize_folded_int8", "calibrate_act_scales", "apply_folded_int8",
           "int8_full_conv_indices", "quantize_folded_int8_full",
           "calibrate_act_scales_full", "apply_folded_int8_full",
           "make_s2d_stem", "make_s2d_stem_int8", "make_s2d_down_int8", "s2d_stem_forward",
           "s2d_train_stem_qualifies", "refuse_grid_sensitive",
           "conv", "conv_layer", "folded_conv", "conv_bias", "activate", "bn_batch_moments",
           "bn_batch_moments_matmul", "bn_moments_from_sums", "bn_running_stats",
           "bn_running_moments", "bn_normalize", "resolve_bn_form", "BN_EPS", "BN_MOMENTUM",
           "BN_FORM", "LEAKY_SLOPE", "walk", "Step", "Runs", "plain_layer", "pool_padding",
           "widen", "nchw", "nhwc", "channels_last"]
