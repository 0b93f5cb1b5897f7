"""Spatial (height) sharding: native-resolution detection and training
across devices (reference package ``parallel/spatial.py``).

The reference detector downsamples every 1536² tile to 416² because one
GPU cannot hold the native-resolution activations.  Spatial sharding
splits the image *height* over the ``sp`` axis of a (dp, sp) mesh (the
batch over ``dp``), so detection runs at the tile's own 1536² (the
stride-8 head sees 192×192 cells instead of 52×52), and so does the
training that native-resolution detection needs.

The reference gets the halo exchanges from GSPMD.  PyTorch has no such
compiler, so this module writes the row choreography itself:

* **Row plan** (:class:`RowPlan`).  The spec's coarsest stride ``D`` (32
  for YOLOv3, 16 for the tests' mini spec) fixes the unit: the coarsest
  map's ``H/D`` rows are split over ``sp`` as evenly as possible (13 rows
  over 2 shards: 7/6; over 4: 4/3/3/3), and every level owns those rows
  scaled by ``D/stride``.  Stride-2 convs and the 2× upsample then map
  owned rows onto owned rows, and routes and shortcuts join maps whose
  rows agree.  The reference's GSPMD splits the input into ``H/sp`` equal
  blocks instead; the plan aligned to ``D`` keeps every level's rows whole.
  Where the coarsest map has fewer rows than ``sp`` (the reference pads),
  the last shards own no rows and take no part.
* **Halos.**  A shard that owns output rows ``[a, b)`` of a conv or pool
  with kernel ``k``, stride ``s`` and pad ``p`` reads input rows
  ``[s·a − p, s·(b − 1) − p + k)``: one row above and one below for a 3×3
  s1 conv, one above for a 3×3 s2 conv, none for 1×1, upsample, route and
  shortcut.  Rows outside the map are the layer's own padding (zero for a
  conv, −inf for a pool, the reference's zero row below a 2/1 pool); rows
  of a neighbour arrive through :func:`~.mesh.to_device`, a
  differentiable copy, so the backward of a halo exchange is autograd's
  sum of those copies' gradients.  The width is padded by the layer as
  before.
* **Lockstep.**  One thread runs the spec layer by layer over every shard
  (a thread per shard would meet at a barrier at every 3×3 conv and every
  BN): ``darknet.walk`` with one map per shard as each layer's value.
  The forward reads parameters through differentiable copies; the train
  step gives each other device leaf copies instead and, after its one
  ``backward()``, adds their gradients into the first device's parameters
  (:func:`leaf_replicas`), so that no gradient crosses cards into a
  parameter inside autograd.  Each BN sums the shards' per-channel ``Σx``
  and ``Σx²`` on the first device with the true element count (height shards are
  unequal) and hands the global statistics back (sync-BN over sp × dp),
  each shard's sums taken as reductions or, in the ``"matmul"`` BN form,
  as products (:mod:`..ops.bnstats`).  The per-layer arithmetic is
  :mod:`..models.darknet`'s own functions.
* **s2d stem.**  The training stem of ``darknet.apply(s2d_stem=True)``
  runs on each shard's rows of the space-to-depth grid, which the row
  plan keeps whole (every shard starts on an even pixel row): conv_a's
  halo is one s2d row each way, conv_b's one row above (:func:`_s2d_stem`).
* **Outputs.**  The head maps are small; they gather on the mesh's first
  device, along H within a dp row and along B across rows, where
  ``decode_all``, ``non_max_suppression`` and ``yolo_loss`` run unchanged.

The reference memoizes its jitted programs (``_FN_CACHE``, ``_memoized``)
because ``jax.jit`` caches by function identity.  PyTorch runs eagerly and
compiles nothing per call, so there is nothing to memoize.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..graphspec import (
    ConvSpec,
    GraphSpec,
    MaxPoolSpec,
    RouteSpec,
    UpsampleSpec,
)
from ..io.weights import StateDict, _bn_key, _conv_key
from ..kernels.bias_leaky import leaky_where
from ..models import darknet, heads
from ..models.darknet import channels_last, nchw, plain_layer
from ..ops import bnstats
from ..ops.loss import yolo_loss
from ..ops.nms import non_max_suppression
from ..ops.preprocess import RECIP_255
from ..utils.spans import TRAIN_AUGMENT, TRAIN_BACKWARD, TRAIN_FORWARD, TRAIN_LOSS, span
from .mesh import Mesh, make_mesh, replicate, to_device
from .steps import Layout, StepFn, _device, _precision, flat_cat, prepare_batch


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A (dp, sp) grid of devices, ``devices`` in row-major order (entry
    ``r·n_sp + c`` is dp row ``r``, sp column ``c``); the first device holds
    the parameters and gathers the results.  Entries may repeat."""
    devices: Tuple[torch.device, ...]
    n_dp: int
    n_sp: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.n_dp, "sp": self.n_sp}

    def device(self, r: int, c: int) -> torch.device:
        return self.devices[r * self.n_sp + c]


def make_spatial_mesh(n_sp: int, n_dp: int = 1, devices: Optional[Sequence] = None
                      ) -> SpatialMesh:
    """A (dp, sp) mesh over ``cuda:0 .. n_sp·n_dp − 1``; it raises
    ``ValueError`` when more devices are asked for than there are.  Or over
    an explicit ``devices`` list of ``n_sp·n_dp`` entries, row-major, which
    may repeat (``["cuda:0"] * 2``, ``["cpu"] * 8``)."""
    if n_sp < 1 or n_dp < 1:
        raise ValueError(f"a spatial mesh needs n_sp, n_dp >= 1, got {n_sp}, {n_dp}")
    flat = make_mesh(n_sp * n_dp, devices)
    return SpatialMesh(flat.devices, n_dp, n_sp)


def layer_strides(spec: GraphSpec) -> Tuple[int, ...]:
    """Each layer's output stride: input rows per row of its map."""
    out: List[int] = []
    s = 1
    for i, layer in enumerate(spec.layers):
        if isinstance(layer, (ConvSpec, MaxPoolSpec)):
            s *= layer.stride
        elif isinstance(layer, UpsampleSpec):
            if s % layer.factor:
                raise ValueError(f"layer {i} upsamples a stride-{s} map by {layer.factor}")
            s //= layer.factor
        elif isinstance(layer, RouteSpec):
            srcs = {out[j] for j in layer.layers}
            if len(srcs) != 1:
                raise ValueError(f"route {i} joins maps of strides {sorted(srcs)}")
            s = srcs.pop()
        out.append(s)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """Which rows of each level every sp shard owns: shard ``c`` owns the
    coarsest map's rows ``bounds[c] .. bounds[c + 1]`` and, at a level of
    stride ``s``, those rows times ``step / s`` (``step`` is the coarsest
    stride ``D``)."""
    height: int
    step: int
    bounds: Tuple[int, ...]

    def rows(self, c: int, stride: int = 1) -> Tuple[int, int]:
        k = self.step // stride
        return self.bounds[c] * k, self.bounds[c + 1] * k

    @property
    def active(self) -> Tuple[int, ...]:
        """The shards that own rows (all of them unless the coarsest map has
        fewer rows than there are shards)."""
        return tuple(c for c in range(len(self.bounds) - 1)
                     if self.bounds[c + 1] > self.bounds[c])


def row_plan(spec: GraphSpec, height: int, n_sp: int) -> RowPlan:
    """The even split of the coarsest map's rows over ``n_sp`` shards, the
    first ones taking one more (``ValueError`` unless the height is a
    multiple of the coarsest stride)."""
    strides = layer_strides(spec)
    step = max(strides)
    if any(step % s for s in strides):
        raise ValueError(f"the strides {sorted(set(strides))} do not all divide {step}")
    if height % step:
        raise ValueError(f"height {height} is not a multiple of the coarsest stride {step}")
    q, r = divmod(height // step, n_sp)
    bounds = [0]
    for c in range(n_sp):
        bounds.append(bounds[-1] + q + (c < r))
    return RowPlan(height, step, tuple(bounds))


@dataclasses.dataclass(frozen=True)
class ImageSharding:
    """Batch over ``dp``, image height over ``sp``, of an NHWC batch (the
    reference's ``NamedSharding(mesh, P("dp", "sp", None, None))``).  The
    height split is a :class:`RowPlan` of the spec and the height."""
    mesh: SpatialMesh

    def plan(self, spec: GraphSpec, height: int) -> RowPlan:
        return row_plan(spec, height, self.mesh.n_sp)

    def shards(self, plan: RowPlan) -> List[Tuple[int, int]]:
        """(dp row, sp column) of every shard that owns rows, row-major."""
        return [(r, c) for r in range(self.mesh.n_dp) for c in plan.active]

    def split(self, x: torch.Tensor, plan: RowPlan) -> List[torch.Tensor]:
        """Each shard's slab of ``x`` (its batch rows, its image rows), on
        its device, in :meth:`shards` order."""
        if x.shape[0] % self.mesh.n_dp:
            raise ValueError(f"batch {x.shape[0]} must divide over the {self.mesh.n_dp} "
                             f"devices of the dp axis")
        b = x.shape[0] // self.mesh.n_dp
        out = []
        for r, c in self.shards(plan):
            lo, hi = plan.rows(c)
            out.append(to_device(x[r * b:(r + 1) * b, lo:hi], self.mesh.device(r, c)))
        return out


def spatial_image_sharding(mesh: SpatialMesh) -> ImageSharding:
    """Batch over ``dp``, image height over ``sp`` (NHWC input)."""
    return ImageSharding(mesh)


def _is_folded(params: Mapping) -> bool:
    """BN-folded params (``{"conv_i": {"w", "b"}}``) rather than a state dict."""
    return isinstance(next(iter(params.values())), Mapping)


def _rows_of(maps: Sequence[torch.Tensor], cols: Sequence[int], own: int, plan: RowPlan,
             stride: int, lo: int, hi: int, device: torch.device, fill: float
             ) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the NCHW level-``stride`` map whose column
    ``cols[j]`` shard holds ``maps[j]``, for the shard of column ``own`` on
    ``device``: its own rows in place, the others' copied over, rows
    outside the map ``fill``."""
    height = plan.height // stride
    ref = maps[0]
    parts = []

    def pad(n: int) -> torch.Tensor:
        return torch.full((ref.shape[0], ref.shape[1], n, ref.shape[3]), fill,
                          dtype=ref.dtype, device=device)

    if lo < 0:
        parts.append(pad(-lo))
    for m, c in zip(maps, cols):
        a, b = plan.rows(c, stride)
        x0, x1 = max(a, lo), min(b, hi)
        if x0 < x1:
            part = m if (x0, x1) == (a, b) else m[:, :, x0 - a:x1 - a]
            parts.append(part if c == own else to_device(part, device))
    if hi > height:
        parts.append(pad(hi - height))
    return parts[0] if len(parts) == 1 else channels_last(torch.cat(parts, dim=2))


def apply_sharded(params, spec: GraphSpec, x: torch.Tensor, mesh: SpatialMesh, *,
                  compute_dtype: torch.dtype = torch.float32, train: bool = False,
                  s2d_stem: bool = False, bn_form: Optional[str] = None,
                  replicas: Optional[Mapping[torch.device, StateDict]] = None):
    """The forward of ``darknet.apply`` (a state dict) or ``apply_folded``
    (folded params, no packs) with the activations sharded over ``mesh``:
    batch over dp, height over sp (see the module docstring).  ``x`` is the
    NHWC batch in [0, 1] (or uint8, scaled by ``float32(1/255)`` on each
    shard).  Returns the f32 NHWC head maps on the mesh's first device, and
    with ``train=True`` the pair ``(head_maps, new_stats)`` as
    ``darknet.apply`` does; the BN statistics are the global batch's.  The
    running statistics of ``new_stats`` come from ``params``, which must
    then be on the first device.

    ``s2d_stem`` (a state dict) runs layers 0-1 as ``darknet.apply(
    s2d_stem=True)`` does, on each shard's rows of the space-to-depth grid
    (:func:`_s2d_stem`).  ``bn_form`` (train mode; ``None`` reads
    ``darknet.BN_FORM`` at each call, as ``darknet.apply`` does) takes each
    shard's sums as reductions (``"reduce"``) or as products
    (``"matmul"``, :mod:`..ops.bnstats`); the s2d stem's two BNs reduce in
    either form, as the unsharded stem's do.

    ``replicas`` (:func:`leaf_replicas`) gives each device its copy of
    ``params``; by default each is a differentiable copy of ``params``."""
    folded = _is_folded(params)
    bn_form = darknet.resolve_bn_form(bn_form)
    if train and folded:
        raise ValueError("training needs unfolded parameters (a state dict)")
    if s2d_stem and folded:
        raise ValueError("the sharded s2d stem is the training stem: it takes a state dict")
    sharding = spatial_image_sharding(mesh)
    plan = sharding.plan(spec, x.shape[1])
    shards = sharding.shards(plan)
    devs = [mesh.device(r, c) for r, c in shards]
    first = mesh.devices[0]
    reps = ([replicas[d] for d in devs] if replicas is not None
            else replicate(params, Mesh(tuple(devs))))
    cols = plan.active
    row_of = [[k for k, (r, _) in enumerate(shards) if r == rr] for rr in range(mesh.n_dp)]

    def prep(s: torch.Tensor) -> torch.Tensor:
        if s.dtype == torch.uint8:
            s = s.to(torch.float32) * RECIP_255
        s = s.to(compute_dtype)
        return channels_last(nchw(darknet._space_to_depth(s) if s2d_stem else s))

    def windows(maps: List[torch.Tensor], s_in: int, top: int, k: int, s: int, s_out: int,
                fill: float) -> List[torch.Tensor]:
        """Each shard's input rows, from the level-``s_in`` ``maps``, for its
        output rows of a k/s layer at level ``s_out``."""
        out = []
        for j, (r, c) in enumerate(shards):
            a, b = plan.rows(c, s_out)
            out.append(_rows_of([maps[m] for m in row_of[r]], cols, c, plan, s_in,
                                s * a - top, s * (b - 1) - top + k, devs[j], fill))
        return out

    strides = layer_strides(spec)
    head_maps: List[List[torch.Tensor]] = [[] for _ in shards]
    new_stats: StateDict = {}
    bn = functools.partial(_sync_bn, params, reps, compute_dtype=compute_dtype, train=train,
                           first=first, new_stats=new_stats)

    def step(i, layer, prev, saved):  # one map per shard
        s_in = strides[i - 1] if i else 1
        if isinstance(layer, ConvSpec):
            wins = windows(prev, s_in, layer.pad, layer.kernel, layer.stride, strides[i], 0.0)
            pad = (0, layer.pad)
            if folded:
                return [darknet.folded_conv(p, i, layer, w, compute_dtype, pad)
                        for p, w in zip(reps, wins)]
            out = [darknet.conv(p[f"{_conv_key(i)}.weight"], layer, w, compute_dtype, pad)
                   for p, w in zip(reps, wins)]
            out = ([darknet.conv_bias(p, i, o, compute_dtype) for p, o in zip(reps, out)]
                   if not layer.batch_normalize else bn(i, out, bn_form=bn_form))
            return [darknet.activate(layer, o) for o in out]
        if isinstance(layer, MaxPoolSpec):  # the window holds its rows of padding
            k, s = layer.kernel, layer.stride
            before, after, value = darknet.pool_padding(k, s)
            return [F.max_pool2d(F.pad(w, (before, after), value=value), k, s)
                    for w in windows(prev, s_in, before, k, s, strides[i], value)]
        return [plain_layer(layer, prev[j], {k: v[j] for k, v in saved.items()}, head_maps[j])
                for j in range(len(shards))]

    prev = [prep(s) for s in sharding.split(x, plan)]
    runs = ({0: (1, lambda xs, _: _s2d_stem(reps, spec, xs, windows, bn, compute_dtype))}
            if s2d_stem else None)
    darknet.walk(spec, step, prev, {}, runs=runs)

    maps = []
    for h in range(len(head_maps[0])):
        rows = [torch.cat([to_device(head_maps[k][h], first) for k in row], dim=1)
                for row in row_of]
        maps.append(torch.cat(rows, dim=0))
    return (maps, new_stats) if train else maps


def leaf_replicas(params: StateDict, mesh: SpatialMesh) -> Dict[torch.device, StateDict]:
    """Each device's copy of ``params``: ``params`` itself on the first
    device, detached copies elsewhere, which are leaves that require
    gradients where ``params`` do.  A gradient then never crosses devices
    into a parameter inside autograd: :func:`add_replica_grads` adds the
    copies' gradients to the first device's after the backward, where a
    differentiable copy would have let autograd accumulate a gradient made
    on another card into a leaf on the first one (the AccumulateGrad stream
    mismatch PyTorch warns of)."""
    first = mesh.devices[0]
    out: Dict[torch.device, StateDict] = {first: params}
    for d in mesh.devices:
        if d not in out:
            out[d] = {k: to_device(v.detach(), d).requires_grad_(v.requires_grad)
                      for k, v in params.items()}
    return out


def add_replica_grads(params: StateDict, replicas: Mapping[torch.device, StateDict]) -> None:
    """Add each replica's gradients into ``params``' ``.grad`` (on the first
    device), as the backward of a differentiable copy would."""
    first = _device(params)
    for d, rep in replicas.items():
        if d == first:
            continue
        for k, v in rep.items():
            if v.grad is None:
                continue
            g = to_device(v.grad, first)
            if params[k].grad is None:
                params[k].grad = g
            else:
                params[k].grad += g


def _s2d_stem(reps: List[StateDict], spec: GraphSpec, xs: List[torch.Tensor],
              windows: Callable, bn: Callable, compute_dtype: torch.dtype
              ) -> List[torch.Tensor]:
    """Layers 0-1 of ``darknet.apply(s2d_stem=True)`` on row shards (the
    unsharded ``darknet._s2d_train_stem``): ``xs`` holds each shard's rows
    of the space-to-depth image, NCHW at level 2 (the row plan's shards
    start and end on even pixel rows, so each maps whole onto s2d rows).
    conv_a, 3×3/s1 on the s2d grid, reads one s2d row above and one below
    its own (two pixel rows each way); conv_b, the 2×2 conv with one zero
    row on top, reads one row of conv_a's activated output above.  Rows
    outside the image are zero, as each conv pads.  Each replica relabels
    its own copy of conv 0's and conv 1's weights, so the gradients land on
    the first device's 3×3 weights; BN 0 takes the statistics of the four
    phases of every shard."""
    darknet._check_s2d_spec(spec)
    l0: ConvSpec = spec.layers[0]  # type: ignore[assignment]
    l1: ConvSpec = spec.layers[1]  # type: ignore[assignment]
    if not (l0.batch_normalize and l1.batch_normalize):
        raise ValueError("s2d training stem requires BN on layers 0-1")

    def relabel(i: int, gather, cin: int, cout: int) -> List[torch.Tensor]:
        return [darknet._s2d_relabel(p[f"{_conv_key(i)}.weight"].to(compute_dtype),
                                     gather(cin, cout, str(x.device)))
                for p, x in zip(reps, xs)]

    wa = relabel(0, darknet._s2d_gather_indices_a, l0.in_ch, l0.out_ch)
    a = [F.conv2d(w, k, padding=(0, 1)) for w, k in zip(windows(xs, 2, 1, 3, 1, 2, 0.0), wa)]
    a = [leaky_where(o) for o in bn(0, a, groups=4)]
    wb = relabel(1, darknet._s2d_gather_indices_b, l1.in_ch, l1.out_ch)
    out = [F.conv2d(channels_last(F.pad(w, (1, 0))), k)
           for w, k in zip(windows(a, 2, 1, 2, 1, 2, 0.0), wb)]
    return [leaky_where(o) for o in bn(1, out)]


def _sync_bn(master: StateDict, reps: List[StateDict], i: int, outs: List[torch.Tensor], *,
             compute_dtype: torch.dtype, train: bool, first: torch.device,
             new_stats: StateDict, groups: int = 1, bn_form: str = "reduce"
             ) -> List[torch.Tensor]:
    """BN ``i`` of every shard's conv output, before the activation.  Train
    mode: the statistics of all shards together (sync-BN), each shard's
    per-channel ``Σx`` and ``Σx²`` over its own rows summed on ``first``
    with the true element count (``groups`` s2d phases count too, as
    ``darknet.bn_batch_moments`` takes them), the new running statistics
    written into ``new_stats``; ``bn_form="matmul"`` (``groups == 1``) takes
    the sums and the normalize's backward sums as products, as
    ``darknet._bn`` does.  Eval mode: the running statistics."""
    if not train:
        return [darknet.bn_normalize(p, i, darknet.widen(o), *darknet.bn_running_moments(p, i),
                                     compute_dtype, groups) for p, o in zip(reps, outs)]
    matmul = bn_form == "matmul" and groups == 1
    total, n = None, 0
    for o in outs:
        b, cc, h, w = o.shape
        if matmul:
            sums = bnstats.channel_sums(darknet.nhwc(o).reshape(-1, cc))
        else:
            v = darknet.widen(o)
            v = v.reshape(b, groups, cc // groups, h, w) if groups > 1 else v
            dims = (0, 1, 3, 4) if groups > 1 else (0, 2, 3)
            sums = (v.sum(dim=dims), (v * v).sum(dim=dims))
        part = to_device(flat_cat(sums), first)
        total = part if total is None else total + part
        n += b * h * w * groups
    mean, var = darknet.bn_moments_from_sums(*total.chunk(2), n)
    new_stats.update(darknet.bn_running_stats(master, i, mean, var, n))
    if matmul:
        inv = torch.rsqrt(var + darknet.BN_EPS)
        key = _bn_key(i)
        return [bnstats.bn_normalize(o, to_device(mean, o.device), to_device(inv, o.device),
                                     p[f"{key}.weight"].to(torch.float32),
                                     p[f"{key}.bias"].to(torch.float32))
                for p, o in zip(reps, outs)]
    return [darknet.bn_normalize(p, i, darknet.widen(o), to_device(mean, o.device),
                                 to_device(var, o.device), compute_dtype, groups)
            for p, o in zip(reps, outs)]


def spatial_forward(params, spec: GraphSpec, tiles, mesh: SpatialMesh,
                    img_dim: Optional[int] = None,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The detector's forward with the activations sharded (batch over dp,
    height over sp) and the decoded predictions ``(B, N, 5 + C)`` on the
    mesh's first device.  ``params`` folded or not; ``tiles`` (B, S, S, 3)
    float input, already normalised (uint8 is scaled by ``1/255``).  float32
    runs with TF32 off on the card."""
    tiles = torch.as_tensor(tiles)
    img_dim = img_dim or tiles.shape[1]
    with torch.no_grad(), _precision(compute_dtype, mesh.devices[0]):
        maps = apply_sharded(params, spec, tiles, mesh, compute_dtype=compute_dtype)
        return heads.decode_all(maps, spec, img_dim)


def spatial_detect(params, spec: GraphSpec, tiles_u8, mesh: SpatialMesh,
                   conf_thres: float = 0.8, nms_thres: float = 0.4, capacity: int = 64,
                   compute_dtype: torch.dtype = torch.float32):
    """Detection at the tiles' native resolution (≥1536²) on a (dp, sp)
    mesh: uint8 tiles → ``× float32(1/255)`` → the height-sharded backbone
    → decode and merging NMS on the gathered head maps.  Boxes come back in
    the input's own pixels (the input is the tile).  Returns ``(dets (B,
    capacity, 7), valid (B, capacity), n_candidates)``, the ``Detector``'s
    contract."""
    tiles_u8 = torch.as_tensor(tiles_u8)
    pred = spatial_forward(params, spec, tiles_u8, mesh, int(tiles_u8.shape[1]),
                           compute_dtype)
    with torch.no_grad():
        return non_max_suppression(pred, conf_thres, nms_thres, capacity, return_count=True)


class SpatialShards:
    """The ``shards`` of a train step (``parallel.steps``) over a (dp, sp)
    mesh: the global batch is prepared on the first device as the
    one-device step prepares it (augmentation draws included), split by
    batch rows and image rows, run height-sharded with global BN
    statistics, and its head maps gathered, where the loss is taken at the
    global batch."""

    def __init__(self, mesh: SpatialMesh):
        self.mesh = mesh

    def run(self, params: StateDict, spec: GraphSpec, batch, rng, img_size: int,
            augment: bool, compute_dtype: torch.dtype, layout: Layout = Layout()):
        """The global batch's loss, its gradient added into ``params``'
        ``.grad``: ``(loss, new_stats, per_head, images)``.  The shards run
        ``layout.s2d_stem`` on their rows (:func:`_s2d_stem`) and the BN
        form ``darknet.BN_FORM`` names at the call, as the one-device step
        does."""
        first = self.mesh.devices[0]
        if _device(params) != first:
            raise ValueError(f"the parameters are on {_device(params)}, not on the mesh's "
                             f"first device {first}")
        with span(TRAIN_AUGMENT):
            images, targets, target_mask = prepare_batch(*batch, img_size, first, augment, rng,
                                                         layout.image_layout)
            if layout.image_layout == "planar":
                images = images.permute(0, 2, 3, 1)  # the NHWC view apply_sharded takes
        with span(TRAIN_FORWARD):
            replicas = leaf_replicas(params, self.mesh)
            maps, new_stats = apply_sharded(params, spec, images, self.mesh,
                                            compute_dtype=compute_dtype, train=True,
                                            s2d_stem=layout.s2d_stem, replicas=replicas)
        with span(TRAIN_LOSS):
            total, per_head = yolo_loss(maps, spec, img_size, targets, target_mask)
        with span(TRAIN_BACKWARD):
            total.backward()
            add_replica_grads(params, replicas)
        return total, new_stats, per_head, images.shape[0]


def shard_spatial_train_step(step_fn: StepFn, mesh: SpatialMesh) -> StepFn:
    """A step of ``make_train_step`` or ``make_accum_train_step`` run with
    the activations height-sharded over ``sp`` and the batch over ``dp``
    (reference ``shard_spatial_train_step``): the same arguments, with the
    global batch; the state stays on the mesh's first device.  Its loss,
    gradients and BN statistics are the one-device step's up to the order
    of the sums."""
    shards = SpatialShards(mesh)

    def sharded(state, images_u8, targets, target_mask, rng, img_size: int):
        return step_fn(state, images_u8, targets, target_mask, rng, img_size, shards=shards)

    return sharded


__all__ = ["SpatialMesh", "make_spatial_mesh", "RowPlan", "row_plan", "layer_strides",
           "ImageSharding", "spatial_image_sharding", "apply_sharded", "leaf_replicas",
           "add_replica_grads", "spatial_forward",
           "spatial_detect", "SpatialShards", "shard_spatial_train_step"]
