"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic, its limits and the per-layer
metric readers are found by name under ``benchmark/`` (``harness/spec.py``).
The run makes its inputs and weights on the card from ``--seed``, warms up
(``setup_s`` runs from the start of this process to the window), measures
for ``--seconds``, compares what the timed path produced with the plain
reference (``benchmark/reference/``), and prints the result as the last
line of standard output: the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics and the device's busy time from a
checked profiler trace.  Each number compared is printed beside its limit
as the last lines of standard error and under ``checks`` in the result.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, it exits non-zero
and prints no result.  The kernels' build directories live inside the
checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown (nvidia-smi unreadable)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # the checkout's root, not this script's folder, leads the path
    sys.path[:] = [ROOT] + [p for p in sys.path[1:] if p != ROOT]
    import torch
    from benchmark.harness import spec

    chips = spec.workload(args.workload, ROOT)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {chips} CUDA card(s), this machine has {have}; "
              "the benchmark measures the card and never falls back to the CPU",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)   # one host thread: no pool of spinning workers beside it
    print(f"# card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    return report(args, torch.device("cuda", 0))


def report(args, device, cell_dict=None, config=None, variant=None) -> int:
    """Everything after the look for a card: the run, the look for JAX, and
    the result.  ``cell_dict``, ``config`` and ``variant`` are the tests'."""
    from benchmark.harness import cell

    out = cell.run_cell(args, device, T0, ROOT, variant=variant, cell=cell_dict,
                        config=config)
    line = cell.result_line(out, bool(args.trace), device, ROOT)
    bad = cell.forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}, which no chip run may import", file=sys.stderr)
        return 3
    print(f"# info: {json.dumps(out['info'])}", file=sys.stderr)
    print(cell.check_lines(out), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
