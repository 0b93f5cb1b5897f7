"""Cells of kind ``detect``: ``Detector.__call__`` on tiles already on the
device, batches in flight and drained to ragged host boxes as
``Detector.detect_dataset`` drains them.

Set-up: weights from the seed (:mod:`.weights`: the reference scheme,
the head convs scaled and the objectness shift worked out with the
reference), the tile
pool (:mod:`.traffic`), the program's ``Detector`` built from the frozen
``.cfg`` with the configuration's options, and warm-up calls on the pool.
The window issues calls until ``--seconds`` have passed, keeping
``in_flight`` batches on the device; each drain waits for its batch's
boxes (``ops/nms.py:dense_to_ragged``) and folds its candidate counts into
the Detector's counters (``account_overflow``).  Latency runs from
entering ``__call__`` to holding the ragged boxes.  After the window: one
call of each pool batch, drawn from the seed among the window's, against
the reference on the same tiles.
"""

from __future__ import annotations

import collections
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..reference import cfg as ref_cfg
from ..reference.detect import detect as ref_detect
from ..reference.model import forward, full_f32
from ..reference.train import resize
from . import compare, trace, traffic, weights
from .cell import steady_heap

FAULTS = ("half_batch", "stale_answer", "altered_answer", "scaled_boxes", "rescaled")


def _program(cfg: dict, sd: Dict[str, torch.Tensor], device, variant: Optional[str]):
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    opts = dict(cfg["detector"])
    if variant == "control":
        opts.update(cfg["control"])
    det = Detector(spec=from_cfg(cfg["cfg_path"]), params=sd, device=device, **opts)
    return det


def _faulty(call, variant: Optional[str]):
    """The timed call with a fault planted underneath (tests and readings
    only): half of each batch left out, the previous batch's answer
    returned, one keeper's confidence altered where it is produced, every
    box's width and height 10% too large about its centre, or the rescale
    to tile pixels 10% too large."""
    if variant not in FAULTS:
        return call
    last = []

    def wrapped(tiles):
        dets, valid, ncand = call(tiles)
        if variant == "half_batch":
            half = dets.shape[0] // 2
            valid, ncand = valid.clone(), ncand.clone()
            valid[half:] = False
            ncand[half:] = 0
        elif variant == "stale_answer":
            if last:
                prev = last.pop()
                last.append((dets, valid, ncand))
                return prev
            last.append((dets, valid, ncand))
        elif variant == "altered_answer":
            dets = dets.clone()
            dets[:, 0, 4] = dets[:, 0, 4] * 0.5
        elif variant == "scaled_boxes":
            dets = dets.clone()
            centre = (dets[..., 0:2] + dets[..., 2:4]) / 2
            half = (dets[..., 2:4] - dets[..., 0:2]) / 2 * 1.1
            dets[..., 0:2], dets[..., 2:4] = centre - half, centre + half
        else:
            dets = dets.clone()
            dets[..., :4] *= 1.1
        return dets, valid, ncand

    return wrapped


def run(opts, cell: dict, cfg: dict, device: torch.device, t0: float,
        variant: Optional[str] = None) -> dict:
    mix, seed = cell["mix"], opts.seed
    net, layers = ref_cfg.layers(cfg["cfg_path"])
    dopts = cfg["detector"]
    model = dopts["model_size"]
    yolos = [l for l in layers if l["type"] == "yolo"]
    b, n_pool, depth = mix["batch"], mix["pool_batches"], mix["in_flight"]

    sd = weights.reference_scheme(layers, traffic.generator(seed, "weights", device), device)
    pool = traffic.tile_pool(mix, seed, device)
    calib = resize(pool[0, :cfg["calibration_tiles"]], model).permute(0, 3, 1, 2).contiguous()
    heads = weights.scale_heads(sd, layers, calib, cfg["head_std"])
    shift = weights.objectness_shift(sd, layers, heads, cfg["objectness_share"],
                                     dopts["conf_thres"])
    del heads, calib
    # the reference's copy, on the host while the program runs
    ref_sd = {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
    det = _program(cfg, sd, device, variant)
    del sd

    def call(tiles):
        with torch.profiler.record_function("bench/call"):
            dets, valid = det(tiles)
        return dets, valid, det._last_ncand

    call = _faulty(call, variant)
    from amyloid_yolo_tpu_torch.ops.nms import dense_to_ragged

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

        def take():
            with trace.warmed_profile() as prof:
                pipeline(depth + 1)
                torch.cuda.synchronize(device)
                prof.step()
                pipeline(k_calls)
                torch.cuda.synchronize(device)
            return prof

        prof, tries = trace.checked_trace(take, unrecorded=mix["unrecorded_per_call"] * k_calls)
        red = trace.reduce(prof)
        del prof
        result["trace"] = red
        result["ctx"] = {"kind": "detect", "trace": red, "steps_traced": k_calls,
                         "layers": layers, "model_size": model, "batch": b,
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
                hm = forward(sd, layers, x)
            reference.extend(ref_detect(hm, yolos, model, mix["tile"], dopts["conf_thres"],
                                        dopts["nms_thres"],
                                        dopts.get("nms_pool") or dopts["capacity"]))
    result["numbers"], diagnostics = compare.detect_numbers(program, reference,
                                                            dopts["conf_thres"])
    result["info"].update(diagnostics)
    result["info"]["ref_candidates_mean"] = float(np.mean([n for _, n, _ in reference]))
    result["info"]["ref_keepers_mean"] = float(np.mean([len(k) for k, _, _ in reference]))
    return result

