#!/usr/bin/env python3
"""K2 (``fused_residual_block``) and K3 (``fused_residual_block_int8``) on
one NVIDIA GPU: an A/B of several checkouts, the times of every tiling
their launch plan weighs, and the fit of the plan's cost model to those
times.  Run from the root of the repo.

    python3 bench_k2.py ROOT [ROOT ...]          # e.g. output/parent . . output/parent
    python3 bench_k2.py --plans k2|k3 OUT.json
    python3 bench_k2.py --fit k2|k3 [TABLE.json]  # on the CPU

A/B: each ROOT is the root of a checkout (one inside this one, in a
git-ignored directory such as ``output/parent``), run in a process of its
own that imports ``amyloid_yolo_tpu_torch`` from that root and everything
else from this checkout's ``chip_smoke.py``: the same inputs
(``k2_stage_inputs``, ``k3_stage_inputs``, seed 0) and timing on every
side.  Per run, K2 and K3 at the five stage shapes of YOLOv3-416 at B=8 and
32 (device time: ``chip_smoke.cuda_ms``, 20 launches queued behind a device
sleep) and the bf16 ``Detector(conf_thres=0.3)`` at B=8 and 32
(``chip_smoke.detector_ms``, host cost included); one JSON line per run,
then the card's name and power limit.

``--plans``: every tiling of ``conv_block.feasible_plans`` for the kernel
at those ten shapes, checked against its plain version (K2 within rtol 2⁻⁷,
atol 2⁻⁶; K3 bit-exact) and timed as above (10 launches), written to
OUT.json in the layout of the kernel's ``PLAN_TIMES``.  ``--fit`` fits the
kernel's ``COST_MODEL`` to such a table and prints, per shape, the modelled
pick's time beside the fastest.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import chip_smoke  # this checkout's, whatever ROOT the package comes from

COLUMNS = ["b", "h", "w", "c", "strip", "col_tile", "oc_tile", "block_n", "warp_n", "ms"]


def _ab(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
    from amyloid_yolo_tpu_torch.io.weights import params_from_jax
    from amyloid_yolo_tpu_torch.kernels import _build
    from amyloid_yolo_tpu_torch.kernels.conv_block import fused_residual_block
    from amyloid_yolo_tpu_torch.kernels.int8_block import fused_residual_block_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    _build.build_all()
    sx, s1, s_out = chip_smoke.K3_SCALES
    out = {"root": root, "k2_ms": {}, "k3_ms": {}, "detector_ms": {}}
    for key, inputs, fn in (
            ("k2_ms", chip_smoke.k2_stage_inputs, fused_residual_block),
            ("k3_ms", chip_smoke.k3_stage_inputs,
             lambda xq, pack: fused_residual_block_int8(xq, *pack, sx=sx, s1=s1, s_out=s_out))):
        for b in chip_smoke.DETECTOR_BATCHES:
            total = 0.0
            for h, c, n in chip_smoke.STAGES:
                args = inputs(b, h, c, dev, gen)
                ms = chip_smoke.cuda_ms(lambda: fn(*args))
                out[key][f"{b}x{h}x{h}x{c}"] = ms
                total += n * ms
                del args
            out[key][f"total_b{b}"] = total
    spec = yolov3_spec(num_classes=2)
    det = Detector(spec, params_from_jax(chip_smoke.random_jax_params(spec, chip_smoke.SEED),
                                         spec), conf_thres=0.3)
    for b in chip_smoke.DETECTOR_BATCHES:
        out["detector_ms"][f"bf16_b{b}"] = chip_smoke.detector_ms(det, b, dev, gen)
    return out


def _kernel(name: str):
    """(KernelDesc, case) of K2 or K3: ``case(b, h, c, dev, gen)`` makes a
    stage's inputs and returns ``(run(plan), check(y, plan))``."""
    import torch

    from amyloid_yolo_tpu_torch.kernels import conv_block, int8_block

    def k2_case(b, h, c, dev, gen):
        args = chip_smoke.k2_stage_inputs(b, h, c, dev, gen)
        want = conv_block.fused_residual_block_plain(*args).float()

        def check(y, plan):
            torch.testing.assert_close(y.float(), want, rtol=chip_smoke.K2_RTOL,
                                       atol=chip_smoke.K2_ATOL, msg=f"plan {plan}")

        return lambda plan: conv_block.fused_residual_block(*args, plan=plan), check

    def k3_case(b, h, c, dev, gen):
        xq, pack = chip_smoke.k3_stage_inputs(b, h, c, dev, gen)
        sx, s1, s_out = chip_smoke.K3_SCALES
        want = int8_block.fused_residual_block_int8_plain(xq, *pack, sx=sx, s1=s1, s_out=s_out)

        def check(y, plan):
            if not torch.equal(y, want):
                raise AssertionError(f"K3 plan {plan} is not bit-exact at {b}x{h}x{h}x{c}")

        return (lambda plan: int8_block.fused_residual_block_int8(
            xq, *pack, sx=sx, s1=s1, s_out=s_out, plan=plan)), check

    return {"k2": (conv_block.K2, k2_case), "k3": (int8_block.K3, k3_case)}[name]


def _plans(name: str, path: str) -> None:
    import torch

    from amyloid_yolo_tpu_torch.kernels import _build
    from amyloid_yolo_tpu_torch.kernels.conv_block import feasible_plans

    kernel, case = _kernel(name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = chip_smoke.nvidia_smi_line()
    _build.build_all()
    rows = []
    for b in chip_smoke.DETECTOR_BATCHES:
        for h, c, _ in chip_smoke.STAGES:
            run, check = case(b, h, c, dev, gen)
            for plan in feasible_plans(h, h, c, kernel):
                check(run(plan), plan)
                ms = chip_smoke.cuda_ms(lambda: run(plan), iters=10)
                rows.append([b, h, h, c, *plan, ms])
            print(f"B={b} {h}x{h}x{c}: {sum(r[:4] == [b, h, h, c] for r in rows)} tilings "
                  f"within tolerance and timed [{card}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"card": card, "sms": sms, "columns": COLUMNS, "rows": rows}, fh)
        fh.write("\n")
    print(card)


def _fit(name: str, path: str) -> None:
    from amyloid_yolo_tpu_torch.kernels.conv_block import (
        fit_cost_model, load_plan_times, modelled_seconds)

    kernel, _ = _kernel(name)
    sms, rows = load_plan_times(path or kernel.plan_times)
    model = fit_cost_model(rows, sms, kernel)
    print(f"fitted COST_MODEL = ({model[0]:.4g}, {model[1]:.4g}, {model[2]:.4g}, "
          f"{model[3]:.4g}); in the code {kernel.cost_model}")
    shapes = {}
    for b, h, w, c, plan, seconds in rows:
        shapes.setdefault((b, h, w, c), []).append((plan, seconds))
    for (b, h, w, c), timed in shapes.items():
        pick = min(timed, key=lambda pt: modelled_seconds(b, h, w, c, pt[0], sms, model,
                                                          kernel))
        best = min(timed, key=lambda pt: pt[1])
        print(f"B={b} {h}x{w}x{c}: {len(timed)} tilings; pick {tuple(pick[0])} "
              f"{pick[1] * 1e3:.4f} ms, fastest {tuple(best[0])} {best[1] * 1e3:.4f} ms "
              f"({pick[1] / best[1]:.3f}x)")


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(_ab(argv[1])), flush=True)
        return 0
    kernels = ("k2", "k3")
    if len(argv) == 3 and argv[0] == "--plans" and argv[1] in kernels:
        _plans(argv[1], argv[2])
        return 0
    if argv[:1] == ["--fit"] and len(argv) in (2, 3) and argv[1] in kernels:
        _fit(argv[1], argv[2] if len(argv) == 3 else None)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
