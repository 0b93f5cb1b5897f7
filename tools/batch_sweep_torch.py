"""Batch operating-point sweep of the port's headline stack on one NVIDIA GPU.

The ``int8_full`` Detector with the s2d stem and the lazy sparse decode,
as ``bench_torch.py`` runs it, at each batch of ``--batches``: one process,
random uint8 1536² tiles already on the card, timed by
``bench_torch.measure`` (best of two repetitions between CUDA events), so
that the sweep cannot drift from the bench's method.  Prints each batch's
ms and tiles/s on stderr and one JSON line ``{"b32": ..., ...}`` of
tiles/s.  Without a CUDA card it raises.

Usage:  python tools/batch_sweep_torch.py [--batches 32,48,64] [--iters 30]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card_line, measure  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="32,48,64")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--precision", default="int8_full")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("batch_sweep_torch.py measures the card, and CUDA is not available")
    from amyloid_yolo_tpu_torch.detectors import Detector

    print(f"# card: {card_line()}", file=sys.stderr)
    batches = [int(b) for b in args.batches.split(",")]
    rng = np.random.RandomState(0)
    tiles = rng.randint(0, 255, (max(batches), 1536, 1536, 3)).astype(np.uint8)

    results = {}
    for b in batches:
        det = Detector(precision=args.precision, int8_downsample=32, lazy_decode=True,
                       s2d_stem=args.precision != "int8_early")
        if args.precision != "bf16":
            det.calibrate(tiles[:2])
        dev = torch.from_numpy(tiles[:b]).to(det.device)
        t = measure(det, dev, args.iters, label=f"b{b}")
        results[b] = b / t
        print(f"b{b}: {t * 1e3:.2f} ms/batch = {b / t:.1f} tiles/s",
              file=sys.stderr, flush=True)
        del det, dev
        torch.cuda.empty_cache()

    print(json.dumps({f"b{b}": round(v, 1) for b, v in results.items()}))
    return results


if __name__ == "__main__":
    main()
