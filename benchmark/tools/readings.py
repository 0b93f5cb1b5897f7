"""The readings that a cell's limits are set from, in one process on the card.

    python3 benchmark/tools/readings.py --workload <cell> --seconds <s>
        [--seeds N] [--control-seeds M] [--faults a,b] [--first-seed S]

For each of ``N`` seeds it runs the cell as the benchmark does (set-up, a
window of ``--seconds``, the comparison) and prints one JSON line with the
numbers compared; then the control (the lower precision in the program's
place) on ``M`` seeds, then each planted fault on ``M`` seeds.  Limits are
not applied here.  The benchmark's own runs never run a control or a fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--first-seed", type=int, default=2_100_000_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import cell

    if not torch.cuda.is_available():
        print("error: the readings are taken on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runs = [(None, args.first_seed + 7919 * k) for k in range(args.seeds)]
    runs += [("control", args.first_seed + 104729 + 7919 * k) for k in range(args.control_seeds)]
    for fault in filter(None, args.faults.split(",")):
        runs += [(fault, args.first_seed + 1299709 + 7919 * k)
                 for k in range(args.control_seeds)]
    for variant, seed in runs:
        t0 = time.perf_counter()
        try:
            opts = SimpleNamespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                   trace=0)
            out = cell.run_cell(opts, device, t0, ROOT, variant=variant)
            rec = {"variant": variant or "program", "seed": seed, "numbers": out["numbers"],
                   "end_to_end": out["end_to_end"], "info": out["info"],
                   "correct": out["correct"]}
        except Exception as e:  # a control that crashes gives no number: recorded, not fatal
            rec = {"variant": variant or "program", "seed": seed, "error": repr(e)[:400]}
        print(json.dumps(rec), flush=True)
        out = None
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
