"""Cells of kind ``detect_v4``: YOLOv4 through ``Detector.__call__``, run as
:mod:`.kind_detect` runs YOLOv3, against YOLOv4's own plain reference
(:mod:`..reference.yolov4`: Mish, SPP, grid-sensitive decode).

Set-up, window, trace and comparison are those of :mod:`.kind_detect`:
weights from the seed (:func:`.weights.reference_scheme`, the head convs
scaled with the YOLOv4 reference's forward, :func:`.weights.
objectness_shift`), the tile pool, warm-up, a window of calls with
``in_flight`` batches on the device drained to ragged host boxes, and after
it one call of each pool batch against the reference on the same tiles.
:func:`.compare.detect_numbers`' ``miss_margin`` is taken over the
reference keepers that lead their merge from inside the NMS pool
(``capacity`` rows) on both sides (:func:`pooled_keepers`): where a tile has
more candidates than the pool, the pool's score cut, which rounding moves,
decides which rows are merged at all, and a sound program missed a keeper
near that cut by 0.0295 (``PERF.md`` §2); a keeper well above it is missed
only by a fault, in the pool's selection as anywhere else.  Where both
sides' candidates fit the pool every keeper counts.  Beside its
three numbers this kind compares two more: ``cand_gap``, the candidate
counts' gap (a diagnostic there), which a batch left unanswered or a wrong
activation moves whole; and ``centre_bias`` (:func:`centre_bias`), which a
decode without ``scale_x_y`` moves at every head.  The traced run also
hands the readers the Mish epilogue's launches over the traced calls
(``ctx["mish_launches"]``).

The control (the readings tool's ``control`` variant) is the program one
precision below bf16: every conv's input and weights rounded to float8
e4m3 under a per-tensor scale (:func:`_fp8`), since the port's int8 paths
take no Mish.  The planted faults are those of :mod:`.kind_detect` and
``mish_as_silu`` (``x·σ(x)`` in the program's Mish epilogue) and
``unscaled_xy`` (the program's graph with every ``scale_x_y`` at 1).

A program without YOLOv4's parts (no ``bias_mish`` epilogue, a graph whose
heads lack ``scale_x_y``) would run the graph wrongly; the run refuses it
before any set-up, with a non-zero exit.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import yolov4 as ref
from ..reference.cfg import conv_key
from ..reference.model import full_f32
from ..reference.train import resize
from . import compare, flops, trace, traffic
from .cell import steady_heap
from .kind_detect import _faulty
from .weights import objectness_shift, reference_scheme

# the widest gap of a row's objectness or class probability that the cell's
# ``conf_gap`` limit admits: a row's score (their product, the pool's order)
# then moves by at most twice it
ROW_GAP = 0.02


@torch.no_grad()
def scale_heads(sd: Dict[str, torch.Tensor], layers: List[dict], x: torch.Tensor,
                head_std: float) -> List[torch.Tensor]:
    """:func:`.weights.scale_heads` with the YOLOv4 reference's forward
    (Mish and all): each head conv's weights scaled so that its maps over
    the NCHW image ``x`` spread by ``head_std``; returns the scaled maps."""
    with full_f32():
        heads = ref.forward(sd, layers, x)
    yolo_at = [i for i, l in enumerate(layers) if l["type"] == "yolo"]
    out = []
    for h, i in zip(heads, yolo_at):
        s = head_std / float(h.std())
        sd[f"{conv_key(i - 1)}.weight"].mul_(s)
        out.append(h * s)
    return out


def _spec(cfg_path: str, yolos: List[dict], variant: Optional[str]):
    """The program's graph of the frozen ``.cfg``; it must carry each head's
    ``scale_x_y`` (``unscaled_xy``: every one set to 1, a planted fault)."""
    from amyloid_yolo_tpu_torch.graphspec import YoloSpec, from_cfg
    spec = from_cfg(cfg_path)
    heads = [l for l in spec.layers if isinstance(l, YoloSpec)]
    got = [getattr(h, "scale_x_y", None) for h in heads]
    if got != [y["scale_x_y"] for y in yolos]:
        raise RuntimeError(f"the program's graph reads scale_x_y {got} where the cfg gives "
                           f"{[y['scale_x_y'] for y in yolos]}: it cannot run YOLOv4")
    if variant == "unscaled_xy":
        layers = tuple(dataclasses.replace(l, scale_x_y=1.0) if isinstance(l, YoloSpec) else l
                       for l in spec.layers)
        spec = dataclasses.replace(spec, layers=layers)
    return spec


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's largest, 448, and brought back to its dtype."""
    s = t.abs().amax().float().clamp(min=1e-30) / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def _silu_epilogue(out: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The planted ``mish_as_silu``: ``x·σ(x)`` where the program takes Mish."""
    y = out + b.to(out.dtype)[None, :, None, None]
    return torch.nn.functional.silu(y.float()).to(out.dtype)


def centre_bias(program, reference, layers: List[dict], model: int, tile: int) -> float:
    """How much of the grid-sensitive stretch the program's centres lack:
    over the pairs of keepers that :func:`.compare.match` makes, the
    absolute median of the centre offset (reference − program) on each axis,
    signed by which half of its cell the reference keeper's leading row
    lies in and divided by its head's ``(s − 1)·stride``, the two axes
    averaged.

    YOLOv4's grid-sensitive decode moves a centre by ``(s − 1)·(σ − ½)·
    stride`` away from its cell's middle.  A decode that leaves it out
    moves every pair inward by ``|σ − ½|`` of that unit, whatever the head
    or the input size, while rounding moves pairs either way and leaves the
    median near 0.  Each reference keeper is traced to its leading row (the
    merging NMS keeps that row's objectness) for its head; pairs from heads
    with ``s`` = 1 take no part.  0 without a pair."""
    sizes = flops.spatial_sizes(layers, model)
    yolos = [(l, sizes[i]) for i, l in enumerate(layers) if l["type"] == "yolo"]
    ends = np.cumsum([len(y["anchors"]) * g * g for y, g in yolos])
    strides = np.array([model / g for _, g in yolos])
    stretch = np.array([(y["scale_x_y"] - 1.0) * model / g for y, g in yolos])
    per_tile = tile / model
    offsets = [np.zeros(0)]
    for (p, _), (r, _, rows) in zip(program, reference):
        pairs = compare.match(p, r)
        if not pairs:
            continue
        i, j = (np.array(x) for x in zip(*pairs))
        lead = np.array([int(np.flatnonzero(rows[:, 4] == r[k, 4])[0]) for k in j])
        head = np.searchsorted(ends, lead, side="right")
        keep = stretch[head] > 0
        i, j, lead, head = i[keep], j[keep], lead[keep], head[keep]
        row_centre = (rows[lead, 0:2] + rows[lead, 2:4]) / 2 / per_tile
        side = np.sign(np.mod(row_centre / strides[head, None], 1.0) - 0.5)
        shift = ((r[j, 0:2] + r[j, 2:4]) - (p[i, 0:2] + p[i, 2:4])) / 2 / per_tile
        offsets.append((shift * side / stretch[head, None]).mean(axis=1))
    offsets = np.concatenate(offsets)
    return float(abs(np.median(offsets))) if len(offsets) else 0.0


def pooled_keepers(program, reference, pool: int, conf_thres: float) -> list:
    """The reference (per tile ``(keepers, candidates, rows)``) with only
    the keepers whose leading row lies in the NMS pool on both sides.

    Where neither side has more than ``pool`` candidates (``program``: per
    tile ``(keepers, candidates)``) each pool holds every candidate and
    every keeper stays.  Elsewhere a keeper stays when its score lies above
    the pool's cut by ``4 · ROW_GAP``: the cut is the score of the first
    row left out of a pool of ``pool`` among the reference's rows whose
    objectness lies within ``ROW_GAP`` of ``conf_thres`` or above (every
    candidate of either side).  On the program's side a row's score lies
    within ``2 · ROW_GAP`` of the reference's and its candidates are among
    those rows, so the program's own cut lies at most ``2 · ROW_GAP`` above
    the reference's, and a row above the reference's cut by ``4 · ROW_GAP``
    is in both pools, as is every row that could lead a merge over it; the
    order of rows of near-equal score, which may hand the lead to a
    neighbour, is what the miss's IoU of 0.3 leaves room for.  A merged
    keeper carries its leading row's objectness and class probability, so
    its score is that row's."""
    out = []
    for (_, n_p), (keep, n_r, rows) in zip(program, reference):
        if max(n_p, n_r) > pool:
            near = rows[rows[:, 4] >= conf_thres - ROW_GAP]
            scores = np.sort(near[:, 4] * near[:, 5:].max(axis=1))[::-1]
            cut = scores[pool] if len(scores) > pool else -np.inf
            keep = keep[keep[:, 4] * keep[:, 5] > cut + 4 * ROW_GAP]
        out.append((keep, n_r, rows))
    return out


def run(opts, cell: dict, cfg: dict, device: torch.device, t0: float,
        variant: Optional[str] = None) -> dict:
    epilogue = importlib.import_module("amyloid_yolo_tpu_torch.kernels.bias_leaky")
    from amyloid_yolo_tpu_torch.models import darknet
    if not hasattr(epilogue, "bias_mish"):
        raise RuntimeError("the program has no Mish epilogue (kernels/bias_leaky.py:bias_mish):"
                           " it cannot run YOLOv4")
    mix, seed = cell["mix"], opts.seed
    _, layers = ref.layers(cfg["cfg_path"])
    yolos = [l for l in layers if l["type"] == "yolo"]
    prog_spec = _spec(cfg["cfg_path"], yolos, variant)
    saved = {"bias_mish": darknet.bias_mish, "conv": darknet.conv}
    if variant == "mish_as_silu":
        darknet.bias_mish = _silu_epilogue
    elif variant == "control":
        conv = saved["conv"]
        darknet.conv = lambda w, layer, x, cd, padding=None: conv(_fp8(w), layer, _fp8(x), cd,
                                                                  padding)
    try:
        return _run(opts, cell, cfg, device, t0, variant, mix, seed, layers, yolos, prog_spec,
                    epilogue)
    finally:
        darknet.bias_mish, darknet.conv = saved["bias_mish"], saved["conv"]


def _run(opts, cell, cfg, device, t0, variant, mix, seed, layers, yolos, prog_spec,
         epilogue) -> dict:
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.ops.nms import dense_to_ragged
    dopts = cfg["detector"]
    model = dopts["model_size"]
    b, n_pool, depth = mix["batch"], mix["pool_batches"], mix["in_flight"]

    sd = reference_scheme(layers, traffic.generator(seed, "weights", device), device)
    pool = traffic.tile_pool(mix, seed, device)
    calib = resize(pool[0, :cfg["calibration_tiles"]], model).permute(0, 3, 1, 2).contiguous()
    heads = scale_heads(sd, layers, calib, cfg["head_std"])
    shift = objectness_shift(sd, layers, heads, cfg["objectness_share"], dopts["conf_thres"])
    del heads, calib
    # the reference's copy, on the host while the program runs
    ref_sd = {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
    det = Detector(spec=prog_spec, params=sd, device=device, **dopts)
    del sd

    def call(tiles):
        with torch.profiler.record_function("bench/call"):
            dets, valid = det(tiles)
        return dets, valid, det._last_ncand

    call = _faulty(call, variant)

    def pipeline(n_calls: int, stop_at: Optional[float] = None, keep=None, lat=None,
                 enq=None) -> int:
        """Issue calls over the pool (``stop_at``: until that host time),
        ``depth`` in flight; returns the tiles drained."""
        inflight = collections.deque()
        done = j = 0

        def drain():
            nonlocal done
            k, pb, ts, (dets, valid, ncand) = inflight.popleft()
            with torch.profiler.record_function("bench/drain"):
                ragged = dense_to_ragged(dets, valid)
                nc = ncand.cpu().numpy()
                det.account_overflow(n_cand=nc)
            if lat is not None:
                lat.append(time.perf_counter() - ts)
            if keep is not None:
                keep.append((k, pb, [(r if r is not None else np.zeros((0, 7), np.float32))
                                     for r in ragged], nc))
            done += len(ragged)

        while (j < n_calls) if stop_at is None else (time.perf_counter() < stop_at):
            pb = j % n_pool
            ts = time.perf_counter()
            out = call(pool[pb])
            if enq is not None:
                enq.append(time.perf_counter() - ts)
            inflight.append((j, pb, ts, out))
            j += 1
            if len(inflight) > depth:
                drain()
        while inflight:
            drain()
        return done

    pipeline(max(mix["warmup_calls"], n_pool))
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    steady_heap()
    setup_s = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    keep, lat, enq = [], [], []
    w0 = time.perf_counter()
    tiles_done = pipeline(0, stop_at=w0 + opts.seconds, keep=keep, lat=lat, enq=enq)
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    result = {"attempted": len(lat), "failed": 0, "setup_s": setup_s, "peak_bytes": peak,
              "info": {"objectness_shift": shift, "calls": len(lat), "tiles": tiles_done,
                       "overflow_images": det.overflow_images,
                       "max_candidates": det.max_candidates_seen,
                       "enqueue_ms_mean": float(np.mean(enq)) * 1e3 if enq else None}}
    result["end_to_end"] = {"tiles_per_s": tiles_done / window_s,
                            "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                            "setup_s": setup_s}
    print(f"# window {window_s:.3f} s: {len(lat)} batches of {b}, {tiles_done} tiles; "
          f"latency samples {len(lat)}, {max(0, len(lat) - int(np.ceil(0.95 * len(lat))))} "
          f"beyond the p95", flush=True, file=sys.stderr)

    if opts.trace:
        k_calls = mix["traced_calls"]
        mish = []

        def take():
            with trace.warmed_profile() as prof:
                pipeline(depth + 1)
                torch.cuda.synchronize(device)
                prof.step()
                before = epilogue.bias_mish.launches
                pipeline(k_calls)
                torch.cuda.synchronize(device)
                mish.append(epilogue.bias_mish.launches - before)
            return prof

        prof, tries = trace.checked_trace(take, unrecorded=mix["unrecorded_per_call"] * k_calls)
        red = trace.reduce(prof)
        del prof
        result["trace"] = red
        result["ctx"] = {"kind": "detect", "trace": red, "steps_traced": k_calls,
                         "layers": layers, "model_size": model, "batch": b,
                         "mish_launches": mish[-1],
                         "window": {"seconds": window_s, "calls": len(lat), "items": tiles_done,
                                    "enqueue_s": enq, "peak_bytes": peak}}
        print(f"# trace tries [records, calls]: {tries}; {red['kinds']}", file=sys.stderr,
              flush=True)

    # the comparison: one call of each pool batch, drawn from the seed
    del det
    if device.type == "cuda":
        torch.cuda.empty_cache()
    by_batch = collections.defaultdict(list)
    for k, pb, ragged, nc in keep:
        by_batch[pb].append((ragged, nc))
    program, reference = [], []
    sd = {k: v.to(device) for k, v in ref_sd.items()}
    block = cfg["reference_block"]
    for pb in sorted(by_batch):
        calls = by_batch[pb]
        pick = traffic.draw_order(len(calls), 1, seed, f"sample-{pb}")[0]
        ragged, nc = calls[pick]
        program.extend(zip(ragged, nc))
        for i in range(0, b, block):
            x = resize(pool[pb, i:i + block], model).permute(0, 3, 1, 2).contiguous()
            with torch.no_grad(), full_f32():
                hm = ref.forward(sd, layers, x)
            reference.extend(ref.detect(hm, yolos, model, mix["tile"], dopts["conf_thres"],
                                        dopts["nms_thres"],
                                        dopts.get("nms_pool") or dopts["capacity"]))
    conf, pool_rows = dopts["conf_thres"], dopts.get("nms_pool") or dopts["capacity"]
    result["numbers"], diagnostics = compare.detect_numbers(program, reference, conf)
    # miss_margin over the keepers that lead their merge from inside both pools
    pooled = pooled_keepers(program, reference, pool_rows, conf)
    result["numbers"]["miss_margin"] = compare.detect_numbers(program, pooled, conf)[0][
        "miss_margin"]
    result["info"]["tiles_over_pool"] = sum(int(max(n_p, n_r) > pool_rows) for (_, n_p),
                                            (_, n_r, _) in zip(program, reference))
    result["info"]["keepers_left_out"] = (sum(len(k) for k, _, _ in reference)
                                          - sum(len(k) for k, _, _ in pooled))
    result["numbers"]["cand_gap"] = diagnostics.pop("cand_gap")
    result["numbers"]["centre_bias"] = centre_bias(program, reference, layers, model,
                                                      mix["tile"])
    result["info"].update(diagnostics)
    result["info"]["ref_candidates_mean"] = float(np.mean([n for _, n, _ in reference]))
    result["info"]["ref_keepers_mean"] = float(np.mean([len(k) for k, _, _ in reference]))
    return result
