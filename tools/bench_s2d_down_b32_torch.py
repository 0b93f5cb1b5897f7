"""A/B of the s2d downsample relabel at batch 32 on one NVIDIA GPU
(``tools/bench_s2d_down_b32.py``'s counterpart).

The ``int8_full`` ``Detector`` with the space-to-depth stem, without and
with ``s2d_downsample`` (the narrow 3x3/s2 convs after the stem on the s2d
grid too), at the reference tool's operating point: B=32 random 1536²
tiles already on the card, calibrated on two of them, the best of
``--repeats`` runs of ``--iters`` calls on the host clock, each ending in a
``torch.cuda.synchronize()``.  ``s2d_downsample`` exists only for
``int8_full`` with the s2d stem, in both packages, so the arms are
``int8_full`` ones; they launch K1 (the resize) once a call and K2 never.
The reference's ``approx_topk=True`` has no counterpart in the port (its
candidate pool is exact).

One JSON line per arm: ``s2d_downsample``, ``batch``, ``ms_per_batch``,
``tiles_per_s``, ``launches_per_call`` (the kernels' own counters),
``device``.  ``--device cpu`` (with ``--side`` and ``--size`` small, for
the tests) runs on the CPU: the times are host times.

Run on the card:  python tools/bench_s2d_down_b32_torch.py [--batch 32] [--iters 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def measure(det, inp, iters: int = 30, repeats: int = 2) -> float:
    """Best seconds a call over ``repeats`` runs of ``iters`` calls, one
    call first."""
    import torch
    sync = torch.cuda.synchronize if det.device.type == "cuda" else (lambda: None)
    det(inp)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            det(inp)
        sync()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def run(batch: int = 32, iters: int = 30, repeats: int = 2, side: int = 1536,
        size: int = 416, device="cuda", spec=None) -> list:
    import torch
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.RandomState(0)
    tiles = rng.randint(0, 255, (batch, side, side, 3)).astype(np.uint8)
    rows = []
    for s2d_down in (False, True):
        det = Detector(spec, precision="int8_full", s2d_stem=True, s2d_downsample=s2d_down,
                       model_size=size, tile_size=side, device=device)
        det.calibrate(tiles[:2])
        inp = torch.from_numpy(tiles).to(det.device)
        reset_launch_counts()
        t = measure(det, inp, iters, repeats)
        calls = 1 + repeats * iters
        name = (torch.cuda.get_device_name(det.device) if det.device.type == "cuda"
                else "cpu")
        rec = {"s2d_downsample": s2d_down, "batch": batch, "ms_per_batch": t * 1e3,
               "tiles_per_s": batch / t,
               "launches_per_call": {k: v / calls for k, v in launch_counts().items()},
               "device": name}
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        del det, inp
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=int(os.environ.get("BENCH_BATCH", "32")))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--side", type=int, default=1536, help="tile side (the tiles are square)")
    ap.add_argument("--size", type=int, default=416, help="the model's input size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench_torch import print_card
    print_card(args.device)
    run(args.batch, args.iters, args.repeats, args.side, args.size, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
