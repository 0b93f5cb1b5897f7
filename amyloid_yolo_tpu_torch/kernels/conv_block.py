"""K2: one BN-folded Darknet residual unit, fused into one kernel.

    y = x + leaky(conv3x3(leaky(conv1x1(x) + b1)) + b2),  slope 0.1

Replaces the reference package's Pallas kernel
``pallas/conv_block.py:fused_residual_block`` (``pl.pallas_call`` at
``:107``) and its packing ``pack_block_weights`` (``:82``), with the same
contract: f32 accumulation and f32 biases, the hidden map cast to
``x.dtype`` between the convs and zero-padded, the residual add in f32 and
then the cast.

The CUDA source is ``csrc/conv_block.cu``.  A block owns one tile, (image,
strip of output rows, range of output columns, range of output channels):
it computes the 1×1 of the tile's pixels plus their one-pixel halo into
shared memory (halo pixels outside the image are not stored; one zero
pixel stands for them), then the 3×3 from there, both as implicit GEMMs on
the tensor cores, bf16 → f32.  Weight k-slices, and in the 1×1 the ``x``
pixels, stream through a ring of 3–8 shared-memory stages fed by
``cp.async``, each slice loaded once per block and read by all eight warps.
The 1×1 runs ``mma.sync`` on ``ldmatrix`` fragments.  The 3×3 runs
``wgmma`` (A from ``ldmatrix`` fragments in registers, B from the ring in
the 128-byte swizzle) where C/2 is a multiple of 64, and ``mma.sync``
otherwise (the 208² × 64 unit): :func:`conv3x3_path`, by shape alone.

:func:`plan_launch` picks the tiling from (B, H, W, C): strip, column
range, output-channel tile, warp width (32 or 64 channels), block tile
width and ring depth.  It ranks the tilings by a cost model of whole waves
on the card's SMs (:func:`modelled_seconds`, its constants fitted by
:func:`fit_cost_model` to the measured times in ``PLAN_TIMES``), and trades
at most ``MAX_EXTRA_WORK`` of recomputed 1×1 and padded rows for
parallelism, measured against the row-strip tiling of :func:`pick_strip`.
:func:`smem_bytes` is the same formula as the C side's
``amyolo_conv_block_smem_bytes``; the plan is computed once per shape.

The planner serves K3 (``kernels/int8_block.py``) too, whose kernel has
the same geometry in bytes: each function takes a :class:`KernelDesc`
(``kernel=``, K2's :data:`K2` by default) with the element size, the
padding and slice depths in elements, and the kernel's own cost model and
table of measured tilings.

Bound on an H100, per launch: ``max(B·20·H·W·C·C/2 / 989 TFLOP/s,
(B·4·H·W·C + 20·C·C/2) B / 3.35 TB/s)`` — compute for the units of 128
channels and more, memory for the 208² × 64 unit.  ``mma.sync`` with
``ldmatrix`` fragments stayed far from it: the warps' instruction stream
(fragment loads, addressing, barriers), not the MMAs, took most of a
launch; ``wgmma`` in the 3×3 takes the B fragments and most MMA issue off
that stream.  TMA, a producer warp and ``wgmma`` in the 1×1 are the next
steps (ROADMAP.md).

:func:`fused_residual_block` launches the kernel for a CUDA tensor (bf16,
C a multiple of 64, 16-byte aligned) and counts the launch in
``fused_residual_block.launches``; for a CPU tensor it runs
:func:`fused_residual_block_plain` in any float dtype; anything else
raises.  f32 on the card is not supported by the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Iterable, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .bias_leaky import LEAKY_SLOPE, leaky_where

MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on Hopper
MAX_STRIP = 8

# The kernels' geometry (csrc/conv_block.cu, csrc/int8_block.cu): 8 warps,
# each owning a 64-pixel tile 32 or 64 channels wide; a ring of 64-byte
# k-slices in rows of 80 bytes (so ldmatrix is free of bank conflicts) for
# the 1x1, whose bytes the 3x3 reuses for deeper slices (K2's wgmma 3x3:
# unpadded 128-byte rows in the 128-byte swizzle); hidden pixels padded by
# 16 bytes.  32-channel warps run two blocks an SM where shared
# memory allows (128 registers a thread); 64-channel warps one, in block
# tiles 128 or 256 channels wide, with a 4-stage ring.
WARPS = 8
WARP_M, RING_ROW_BYTES = 64, 80
BLOCK_N = {32: (64, 128), 64: (128, 256)}  # block tile widths by warp width
RING_STAGES = {32: 3, 64: 4}   # 1x1 ring stages by warp width
SM_SMEM_BYTES = 233472         # shared memory of one SM
SMEM_RESERVED = 1024           # per resident block
MAX_EXTRA_WORK = 0.05
MAX_TILE_ROWS = 16
MAX_COL_TILES = 8

# Cost model of a wave of tiles on one SM, used only to rank tilings:
# the executed MMA FLOPs of the SM's blocks at a rate per warp width, plus a
# cost per k-step (barrier, latency) and per tile (prologue, epilogue) that
# blocks sharing an SM overlap.  (SM FLOP/s with 32-channel warps, with
# 64-channel warps, s per k-step, s per tile), fitted by
# :func:`fit_cost_model` to the H100 times in ``PLAN_TIMES`` of every tiling
# that :func:`plan_launch` weighs at the five stages of YOLOv3-416, B=8 and
# 32 (``bench_k2.py --plans`` measures them).
COST_MODEL = (6.918e12, 4.892e12, 0.7244e-6, 2.570e-6)
PLAN_TIMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "conv_block_plan_times.json")


class KernelDesc(NamedTuple):
    """What the planner needs of a residual-unit kernel on this geometry:
    element size, padding per hidden pixel and k-slice depths in elements
    (16 and 64 bytes), the cost model and its table of measured tilings."""

    name: str
    elem_bytes: int
    hidden_pad: int
    k_slice1: int                    # 1x1 channels per ring stage
    k_slices2: Tuple[int, ...]       # 3x3 slice depths: the first that divides C/2
    cost_model: Tuple[float, float, float, float]
    plan_times: str

    def k_slice2(self, c2: int) -> int:
        return next(k for k in self.k_slices2 if c2 % k == 0)


K2 = KernelDesc("fused_residual_block", 2, 8, 32, (64, 32), COST_MODEL, PLAN_TIMES)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_block")
    if lib.amyolo_fused_residual_block.argtypes is None:
        lib.amyolo_fused_residual_block.argtypes = [_P] * 6 + [_I] * 11 + [_P]
        lib.amyolo_fused_residual_block.restype = ctypes.c_int
        lib.amyolo_conv_block_smem_bytes.argtypes = [_I] * 7
        lib.amyolo_conv_block_smem_bytes.restype = ctypes.c_int
        lib.amyolo_conv_block_blocks_per_sm.argtypes = [_I] * 4
        lib.amyolo_conv_block_blocks_per_sm.restype = ctypes.c_int
    return lib


def pack_block_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, ...]:
    """Folded OIHW conv params → the kernel's layouts.

    ``w1`` (C2, C, 1, 1) → ``w1t`` (C2, C); ``w2`` (C, C2, 3, 3) → ``w2t``
    (9, C, C2), tap ``3·di + dj``; both in ``dtype`` with the input channel
    contiguous.  Biases stay f32.
    """
    c2, c = w1.shape[0], w1.shape[1]
    w1t = w1.reshape(c2, c).to(dtype).contiguous()
    w2t = w2.permute(2, 3, 0, 1).reshape(9, c, c2).to(dtype).contiguous()
    return (w1t, b1.to(torch.float32).contiguous(),
            w2t, b2.to(torch.float32).contiguous())


def fused_residual_block_plain(x: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor,
                               w2t: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2 on NHWC ``x``: every product in f32 (x and the
    weights upcast), the hidden map rounded to ``x.dtype`` at the same point
    as the kernel.  On the card, f32 convolutions must run with TF32 off."""
    f32 = torch.float32
    c2, c = w1t.shape
    xf = x.to(f32)
    h = leaky_where(xf @ w1t.to(f32).t() + b1.to(f32)).to(x.dtype).to(f32)
    w2 = w2t.to(f32).reshape(3, 3, c, c2).permute(2, 3, 0, 1)
    acc = F.conv2d(h.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    return (xf + leaky_where(acc + b2.to(f32))).to(x.dtype)


def conv3x3_path(c: int) -> str:
    """Which 3×3 the kernel runs for a C-channel unit, by C/2 alone (the C
    side's ``dispatch``): ``"wgmma"`` in 64-channel slices where C/2 is a
    multiple of 64, else ``"mma.sync"`` in 32-channel slices."""
    return "wgmma" if K2.k_slice2(c // 2) == 64 else "mma.sync"


def pick_strip(h: int, fits) -> int:
    """Output rows per block: at most ``MAX_STRIP``, balanced over ``h``,
    and the largest for which ``fits(strip)`` (shared memory) holds; 0 if
    none does."""
    n_strips = -(-h // MAX_STRIP)
    strip = -(-h // n_strips)
    while strip > 0 and not fits(strip):
        strip -= 1
    return strip


class Plan(NamedTuple):
    """K2's tiling of a (B, H, W, C) unit: a block per tile of ``strip``
    output rows × ``col_tile`` output columns × ``oc_tile`` output channels;
    warps of 64 pixels × ``warp_n`` channels in GEMM block tiles
    ``block_n`` channels wide."""

    strip: int
    col_tile: int
    oc_tile: int
    block_n: int
    warp_n: int = 32

    @property
    def block_m(self) -> int:
        return WARPS * WARP_M * self.warp_n // self.block_n


class PlanStats(NamedTuple):
    grid: int            # blocks (tiles)
    smem: int            # dynamic shared memory per block, bytes
    blocks_per_sm: int   # resident blocks per SM that shared memory allows
    waves: float         # grid / (SMs · blocks_per_sm)
    work_ratio: float    # MMA FLOPs executed / the unit's FLOPs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(h: int, w: int, c: int, plan: Plan, kernel: KernelDesc = K2) -> int:
    """Dynamic shared memory of one block: the tile's hidden pixels (halo
    included, image pixels only) plus one zero pixel, each ``C/2`` elements
    and the padding, then the ring.  Mirrors ``amyolo_conv_block_smem_bytes``
    (``amyolo_int8_block_smem_bytes`` for K3)."""
    hidden = min(plan.strip + 2, h) * min(plan.col_tile + 2, w) + 1
    ring = RING_STAGES[plan.warp_n] * (plan.block_m + plan.block_n) * RING_ROW_BYTES
    return kernel.elem_bytes * hidden * (c // 2 + kernel.hidden_pad) + ring


def blocks_per_sm(smem: int, plan: Plan) -> int:
    """Resident blocks an SM: two at most (128 registers a thread), and one
    for 64-channel warps."""
    return min(2 if plan.warp_n == 32 else 1, SM_SMEM_BYTES // (smem + SMEM_RESERVED))


def _spans(n: int, t: int) -> Iterator[Tuple[int, int]]:
    for s in range(0, n, t):
        yield s, min(t, n - s)


def _halo(start: int, size: int, n: int) -> int:
    """Pixels of [start - 1, start + size] that lie inside [0, n)."""
    return min(start + size, n - 1) - max(start - 1, 0) + 1


def _gemm(m: int, n: int, k: int, bm: int, bn: int, k_slice: int) -> Tuple[int, int]:
    """(executed FLOPs, k-steps) of an (m, n, k) GEMM cut into
    (bm, bn) block tiles and ``k_slice``-deep steps: m16 row tiles past ``m``
    and warps whose 32 channels lie past ``n`` issue no MMA."""
    flops = 0
    for _, mv in _spans(m, bm):
        flops += _cdiv(mv, 16) * 16 * n * k * 2
    return flops, _cdiv(m, bm) * _cdiv(n, bn) * (k // k_slice)


def tiles(b: int, h: int, w: int, c: int, plan: Plan) -> Iterator[Tuple[int, int, int, int, int, int]]:
    """Each block's (image, first row, rows, first column, columns, first
    output channel), in ``blockIdx.x`` order, as the kernel decodes it."""
    for img in range(b):
        for r0, rows in _spans(h, plan.strip):
            for c0, cols in _spans(w, plan.col_tile):
                for oc0 in range(0, c, plan.oc_tile):
                    yield img, r0, rows, c0, cols, oc0


@functools.lru_cache(maxsize=None)
def _tile_costs(h: int, w: int, c: int, plan: Plan,
                kernel: KernelDesc = K2) -> Tuple[int, Tuple[int, int]]:
    """Executed MMA FLOPs of one image, and (FLOPs, k-steps) of its
    largest tile."""
    c2 = c // 2
    bm, bn = plan.block_m, plan.block_n
    n_oc = c // plan.oc_tile
    rows = [(_halo(r0, rr, h), rr) for r0, rr in _spans(h, plan.strip)]
    cols = [(_halo(c0, cc, w), cc) for c0, cc in _spans(w, plan.col_tile)]
    total, worst = 0, (0, 0)
    for (nhr, rr), k_r in _count(rows).items():
        for (nhc, cc), k_c in _count(cols).items():
            f1, s1 = _gemm(nhr * nhc, c2, c, bm, bn, kernel.k_slice1)
            f2, s2 = _gemm(rr * cc, plan.oc_tile, 9 * c2, bm, bn, kernel.k_slice2(c2))
            total += k_r * k_c * n_oc * (f1 + f2)
            worst = max(worst, (f1 + f2, s1 + s2))
    return total, worst


def _count(items):
    out = {}
    for it in items:
        out[it] = out.get(it, 0) + 1
    return out


def unit_flops(h: int, w: int, c: int) -> int:
    """FLOPs of one image's unit: 2·H·W·C·C/2 (1×1) + 18·H·W·C·C/2 (3×3)."""
    return 20 * h * w * c * (c // 2)


def plan_stats(b: int, h: int, w: int, c: int, plan: Plan, sms: int = 132,
               kernel: KernelDesc = K2) -> PlanStats:
    smem = smem_bytes(h, w, c, plan, kernel)
    bps = blocks_per_sm(smem, plan)
    grid = b * _cdiv(h, plan.strip) * _cdiv(w, plan.col_tile) * (c // plan.oc_tile)
    flops, _ = _tile_costs(h, w, c, plan, kernel)
    return PlanStats(grid, smem, bps, grid / (sms * max(bps, 1)), flops / unit_flops(h, w, c))


def strip_work_ratio(h: int, w: int, c: int, kernel: KernelDesc = K2) -> float:
    """Executed-work ratio of the row-strip tiling (each kernel's first
    version): strips from :func:`pick_strip`, whole rows, 128-channel output
    tiles, 64-pixel warp tiles, halo rows computed everywhere."""
    c2 = c // 2
    strip = pick_strip(h, lambda s: (s + 2) * (w + 2) * (c2 + kernel.hidden_pad)
                       * kernel.elem_bytes <= MAX_SMEM_BYTES)
    oc = min(c, 128)
    flops = 0
    for _, rows in _spans(h, strip):
        flops += (c // oc) * _cdiv((rows + 2) * w, 64) * 64 * c2 * c * 2
        flops += _cdiv(rows * w, 64) * 64 * c * 9 * c2 * 2
    return flops / unit_flops(h, w, c)


def _candidates(h: int, w: int, c: int, strips: Optional[Sequence[int]] = None
                ) -> Iterator[Plan]:
    if strips is None:
        strips = sorted({_cdiv(h, n) for n in range(_cdiv(h, MAX_TILE_ROWS), h + 1)})
    col_tiles = sorted({_cdiv(w, n) for n in range(1, min(MAX_COL_TILES, w) + 1)})
    for strip in strips:
        for col in col_tiles:
            for oc in (64, 128, 256, 512, 1024):
                if oc > c or c % oc:
                    continue
                for warp_n, widths in BLOCK_N.items():
                    if warp_n == 64 and (c // 2) % 64:
                        continue
                    for bn in widths:
                        if oc % bn == 0:
                            yield Plan(strip, col, oc, bn, warp_n)


def fits_in_smem(h: int, w: int, c: int, plan: Plan, kernel: KernelDesc = K2) -> bool:
    """Whether a block of ``plan`` fits in shared memory."""
    smem = smem_bytes(h, w, c, plan, kernel)
    return smem <= MAX_SMEM_BYTES and blocks_per_sm(smem, plan) > 0


def feasible_plans(h: int, w: int, c: int, kernel: KernelDesc = K2) -> Iterator[Plan]:
    """The tilings :func:`plan_launch` weighs: those that fit in shared
    memory and execute at most ``MAX_EXTRA_WORK`` more MMA work than
    :func:`strip_work_ratio`."""
    if c % 64:
        raise ValueError(f"{kernel.name} needs C % 64 == 0, got C={c}")
    cap = strip_work_ratio(h, w, c, kernel) + MAX_EXTRA_WORK
    for plan in _candidates(h, w, c):
        if (fits_in_smem(h, w, c, plan, kernel)
                and _tile_costs(h, w, c, plan, kernel)[0] / unit_flops(h, w, c) <= cap):
            yield plan


def _cost_terms(b: int, h: int, w: int, c: int, plan: Plan, sms: int,
                kernel: KernelDesc) -> Tuple[int, int, int]:
    """(whole waves, MMA FLOPs of an SM's blocks in a wave, k-steps of a
    block), the waves and blocks counted at the largest tile."""
    bps = blocks_per_sm(smem_bytes(h, w, c, plan, kernel), plan)
    grid = b * _cdiv(h, plan.strip) * _cdiv(w, plan.col_tile) * (c // plan.oc_tile)
    _, (tile_flops, tile_steps) = _tile_costs(h, w, c, plan, kernel)
    return _cdiv(grid, sms * bps), bps * tile_flops, tile_steps


def modelled_seconds(b: int, h: int, w: int, c: int, plan: Plan, sms: int = 132,
                     model: Optional[Sequence[float]] = None,
                     kernel: KernelDesc = K2) -> float:
    """The cost model's time of a launch; ``model`` defaults to the
    kernel's own."""
    flops32, flops64, step_s, tile_s = model or kernel.cost_model
    waves, sm_flops, steps = _cost_terms(b, h, w, c, plan, sms, kernel)
    rate = flops32 if plan.warp_n == 32 else flops64
    return waves * (sm_flops / rate + steps * step_s + tile_s)


def fit_cost_model(rows: Iterable[Tuple[int, int, int, int, Plan, float]],
                   sms: int = 132, kernel: KernelDesc = K2) -> Tuple[float, float, float, float]:
    """``COST_MODEL`` from measured times, rows of (B, H, W, C, plan,
    seconds) that time every feasible tiling of some shapes.  The model only
    ranks tilings, so its shape is chosen on a log grid (32- over 64-channel
    warp rate, k-step and tile cost in 32-channel-warp FLOPs) for the least
    mean, over the shapes, of the measured time of its pick over the
    fastest tiling's; of the grid points that tie, the one that fits the
    times best in relative least squares, scaled to seconds."""
    import itertools
    import numpy as np
    feats, secs, shape_of = [], [], []
    for b, h, w, c, plan, seconds in rows:
        waves, sm_flops, steps = _cost_terms(b, h, w, c, plan, sms, kernel)
        wide = plan.warp_n == 64
        feats.append([waves * sm_flops * (not wide), waves * sm_flops * wide,
                      waves * steps, waves])
        secs.append(seconds)
        shape_of.append((b, h, w, c))
    feats, secs = np.asarray(feats, np.float64), np.asarray(secs, np.float64)
    shapes = [np.array([i for i, s in enumerate(shape_of) if s == key])
              for key in dict.fromkeys(shape_of)]
    grid = np.array([(1.0, ratio, step, tile) for ratio, step, tile in itertools.product(
        np.geomspace(0.5, 2.0, 41), np.geomspace(1e4, 1e8, 41),
        np.concatenate([[0.0], np.geomspace(1e3, 1e9, 49)]))])
    loss = np.zeros(len(grid))
    for lo in range(0, len(grid), 8192):  # chunks bound the memory
        g = grid[lo:lo + 8192].T
        for i in shapes:
            pick = np.argmin(feats[i] @ g, axis=0)
            loss[lo:lo + 8192] += secs[i][pick] / secs[i].min() / len(shapes)
    tied = grid[loss <= loss.min() + 1e-12]
    m = (feats @ tied.T) / secs[:, None]
    scale = m.sum(0) / (m * m).sum(0)  # least squares of scale * m = 1
    j = int(np.argmin(((scale * m - 1.0) ** 2).sum(0)))
    x = tied[j] * scale[j]
    return float(1.0 / x[0]), float(1.0 / x[1]), float(x[2]), float(x[3])


def load_plan_times(path: str = PLAN_TIMES):
    """(SMs, rows of (B, H, W, C, plan, seconds)) from a table of measured
    tilings (``bench_k2.py --plans``)."""
    import json
    with open(path) as fh:
        table = json.load(fh)
    col = {name: i for i, name in enumerate(table["columns"])}
    rows = [(r[col["b"]], r[col["h"]], r[col["w"]], r[col["c"]],
             Plan(*(r[col[f]] for f in Plan._fields)), r[col["ms"]] / 1e3)
            for r in table["rows"]]
    return table["sms"], rows


@functools.lru_cache(maxsize=None)
def plan_launch(b: int, h: int, w: int, c: int, sms: int = 132, kernel: KernelDesc = K2,
                strip: Optional[int] = None) -> Plan:
    """The tiling of a (B, H, W, C) unit on a card with ``sms`` SMs: of
    :func:`feasible_plans`, the one of least :func:`modelled_seconds`.  A
    caller's ``strip`` restricts the choice to the tilings of that strip
    that fit in shared memory, whatever work they add."""
    if strip is None:
        plans = list(feasible_plans(h, w, c, kernel))
    else:
        plans = [p for p in _candidates(h, w, c, [strip]) if fits_in_smem(h, w, c, p, kernel)]
    if not plans:
        raise ValueError(f"{kernel.name}: no tiling of H={h}, W={w}, C={c}, "
                         f"strip={strip} fits in shared memory")
    return min(plans, key=lambda p: modelled_seconds(b, h, w, c, p, sms, kernel=kernel))


def fused_residual_block(x: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor,
                         w2t: torch.Tensor, b2: torch.Tensor,
                         plan: Optional[Plan] = None) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, C); packed weights from
    :func:`pack_block_weights`.  On the card, ``plan`` (default
    :func:`plan_launch`'s) is the tiling; one that does not fit raises."""
    if x.dim() != 4:
        raise ValueError(f"fused_residual_block takes NHWC x, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    c2 = c // 2
    if (tuple(w1t.shape) != (c2, c) or tuple(w2t.shape) != (9, c, c2)
            or tuple(b1.shape) != (c2,) or tuple(b2.shape) != (c,)):
        raise ValueError("fused_residual_block: packed weights do not match x's "
                         f"{c} channels")
    if x.device.type == "cpu":
        return fused_residual_block_plain(x, w1t, b1, w2t, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_block: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or w1t.dtype != torch.bfloat16 or w2t.dtype != torch.bfloat16:
        raise ValueError("fused_residual_block on CUDA takes bf16 x and weights "
                         f"(got {x.dtype}, {w1t.dtype}, {w2t.dtype}); f32 runs "
                         "only through the plain version on the CPU")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError("fused_residual_block: biases must be float32")
    if c % 64 != 0:
        raise ValueError(f"fused_residual_block on CUDA needs C % 64 == 0, got C={c}")
    tensors = (x, w1t, b1, w2t, b2)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_residual_block: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_residual_block: tensors must be contiguous (x NHWC)")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_residual_block: tensors must be 16-byte aligned (cp.async)")
    if plan is None:
        plan = plan_launch(b, h, w, c, sm_count(x.device))
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.amyolo_fused_residual_block(
            x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), y.data_ptr(), b, h, w, c, c2, plan.strip, plan.col_tile,
            plan.oc_tile, plan.warp_n, plan.block_n, smem_bytes(h, w, c, plan),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_residual_block kernel launch")
    fused_residual_block.launches += 1
    return y


fused_residual_block.launches = 0


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def c_smem_bytes(h: int, w: int, c: int, plan: Plan) -> int:
    """The C side's shared-memory formula (needs the built library)."""
    return _lib().amyolo_conv_block_smem_bytes(h, w, c // 2, plan.strip, plan.col_tile,
                                               plan.warp_n, plan.block_n)


def c_blocks_per_sm(c: int, plan: Plan, smem: int) -> int:
    """Resident blocks per SM from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    n = _lib().amyolo_conv_block_blocks_per_sm(plan.warp_n, plan.block_n, c // 2, smem)
    if n < 0:
        _build.check(-n, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return n


__all__ = ["fused_residual_block", "fused_residual_block_plain", "pack_block_weights",
           "Plan", "PlanStats", "KernelDesc", "K2", "plan_launch", "plan_stats",
           "smem_bytes", "blocks_per_sm", "fits_in_smem", "tiles", "feasible_plans",
           "modelled_seconds", "fit_cost_model", "load_plan_times", "strip_work_ratio",
           "unit_flops", "pick_strip", "conv3x3_path", "sm_count", "c_smem_bytes",
           "c_blocks_per_sm",
           "COST_MODEL", "PLAN_TIMES", "LEAKY_SLOPE", "MAX_SMEM_BYTES"]
