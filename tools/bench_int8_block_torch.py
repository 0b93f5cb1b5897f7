"""A/B of one int8 residual unit on one NVIDIA GPU: K3, the fused int8
block (``csrc/int8_block.cu``), against the executor's int8 unit and the
int32-accumulating plain version, at the backbone's unit shapes.

Three arms, each a chain of ``--chain`` applications (every one's output
the next one's input) inside one timed window, ``--iters`` windows
between CUDA events after a ~20 ms device sleep, so that the host has
queued the window before the device reaches it:

* ``executor_int8 (bf16 sums)``: the executor's int8 convs and f32
  epilogue as ``int8_full`` runs them (``models/darknet.py:_int8_conv``,
  exact int32 sums rounded to bf16), composed as the reference tool's
  ``prod_block`` composes them (``tools/bench_int8_block.py``);
* ``plain_int32``: K3's plain version (``kernels/int8_block.py:
  fused_residual_block_int8_plain``), exact int32 sums;
* ``k3``: ``fused_residual_block_int8`` with its planner's launch plan.

The weights, scales and inputs are the reference tool's numpy draws
(``np.random.RandomState(0)``, shape after shape).  K3's output on the
first application must equal the plain version's exactly; a mismatch
raises.  Prints ms per unit-batch and GOP/s per arm, K3's plan and its
bound (``tools/mfu_torch.py``'s H100 peaks), and one JSON line.

Run on the card:  python tools/bench_int8_block_torch.py [--iters 5] [--batch 16]
``--device cpu`` runs every arm on the CPU (K3 takes its plain version
there; the times are the host's, labelled ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

SHAPES = ("104,128,64,26", "52,256,128,26", "26,512,256,26", "13,1024,512,13")
SCALES = (0.011, 0.017, 0.023)  # sx, s1, s_out of the reference tool
HOLD_CYCLES = 40_000_000        # ~20 ms at 1.98 GHz


def unit_draws(rng: np.random.RandomState, h: int, c: int, c2: int, b: int) -> dict:
    """The reference tool's draws for one shape, in its order (HWIO weights)."""
    d = {"w1q": rng.randint(-127, 128, (1, 1, c, c2)).astype(np.int8),
         "w2q": rng.randint(-127, 128, (3, 3, c2, c)).astype(np.int8),
         "ws1": rng.uniform(1e-3, 2e-2, c2).astype(np.float32),
         "ws2": rng.uniform(1e-3, 2e-2, c).astype(np.float32),
         "b1": rng.uniform(-1, 1, c2).astype(np.float32),
         "b2": rng.uniform(-1, 1, c).astype(np.float32)}
    d["xq"] = rng.randint(-127, 128, (b, h, h, c)).astype(np.int8)
    return d


def make_arms(d: dict, dev):
    """``{name: fn(xq) -> xq}`` for the three arms on ``dev``, and K3's pack."""
    import torch
    from amyloid_yolo_tpu_torch.graphspec import ConvSpec
    from amyloid_yolo_tpu_torch.kernels.int8_block import (
        fused_residual_block_int8, fused_residual_block_int8_plain, pack_int8_block)
    from amyloid_yolo_tpu_torch.models.darknet import _int8_conv
    from amyloid_yolo_tpu_torch.ops.int8 import requant

    sx, s1, s_out = SCALES
    c, c2 = d["w1q"].shape[2], d["w1q"].shape[3]
    t = {k: torch.from_numpy(v) for k, v in d.items() if k != "xq"}
    w1 = t["w1q"].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    w2 = t["w2q"].permute(3, 2, 0, 1).contiguous()
    w1t, ws1, b1, w2t, ws2, b2 = pack_int8_block(w1, t["ws1"], t["b1"], w2, t["ws2"], t["b2"])
    pack = tuple(v.to(dev) for v in (w1t, ws1 * sx, b1, w2t, ws2 * s1, b2))
    conv1 = {"wq": w1.to(dev), "ws": t["ws1"].to(dev), "b": t["b1"].to(dev)}
    conv2 = {"wq": w2.to(dev), "ws": t["ws2"].to(dev), "b": t["b2"].to(dev)}
    l1 = ConvSpec(0, c, c2, 1, 1, True, "leaky")
    l2 = ConvSpec(1, c2, c, 3, 1, True, "leaky")

    def executor(x):
        hq = requant(_int8_conv(conv1, x, sx, l1, False), s1)
        y = _int8_conv(conv2, hq, s1, l2, False) + x.to(torch.float32) * sx
        return requant(y, s_out)

    def plain(x):
        return fused_residual_block_int8_plain(x, *pack, sx=sx, s1=s1, s_out=s_out)

    def k3(x):
        return fused_residual_block_int8(x, *pack, sx=sx, s1=s1, s_out=s_out)

    return {"executor_int8 (bf16 sums)": executor, "plain_int32": plain, "k3": k3}, pack


def time_chain(fn, x, iters: int, chain: int, dev) -> float:
    """ms per application: ``iters`` windows of ``chain`` chained
    applications, after one warm-up chain; CUDA events on the card, the
    host clock on the CPU."""
    import torch

    def window(v):
        for _ in range(chain):
            v = fn(v)
        return v

    x = window(x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(iters):
            x = window(x)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (iters * chain)
    t0 = time.perf_counter()
    for _ in range(iters):
        x = window(x)
    return (time.perf_counter() - t0) * 1e3 / (iters * chain)


def k3_bound(b: int, h: int, c: int) -> tuple:
    """(ms, "operations" | "bytes"): the least time of one K3 launch on an
    H100: int8 ops over 1979 TOP/s, or x read, y written and the weights
    read once over 3.35 TB/s."""
    from mfu_torch import H100_HBM_TBPS, H100_INT8_TOPS
    ops = b * 20 * h * h * c * (c // 2)
    nbytes = b * 2 * h * h * c + 10 * c * (c // 2)
    t_ops, t_bytes = ops / H100_INT8_TOPS / 1e9, nbytes / H100_HBM_TBPS / 1e9
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run(shapes=SHAPES, batch: int = 16, chain: int = 24, iters: int = 5,
        device="cuda") -> list:
    """Time the three arms at each ``H,C,C2,strip`` shape; one record each."""
    import torch
    from amyloid_yolo_tpu_torch.kernels.conv_block import plan_launch, sm_count
    from amyloid_yolo_tpu_torch.kernels.int8_block import K3
    from amyloid_yolo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.RandomState(0)
    rows = []
    for shape in shapes:
        h, c, c2, strip = map(int, shape.split(","))
        d = unit_draws(rng, h, c, c2, batch)
        arms, _ = make_arms(d, dev)
        xq = torch.from_numpy(d["xq"]).to(dev)
        gop = (h * h * c * c2 * 2 + h * h * c2 * c * 9 * 2) * batch / 1e9
        print(f"unit {h}²×{c}→{c2}→{c}  b{batch}  chain {chain}  ({gop:.2f} GOP/batch) "
              f"[{name}]", flush=True)
        with torch.inference_mode():
            first = {k: fn(xq) for k, fn in arms.items()}
            n_diff = int((first["k3"] != first["plain_int32"]).sum())
            print(f"  K3 against plain_int32 on the first application: {n_diff} of "
                  f"{first['k3'].numel()} levels differ (tolerance: bit-exact)", flush=True)
            if n_diff:
                raise AssertionError(f"K3 is not bit-exact to its plain version at {shape}")
            ms = {k: time_chain(fn, xq, iters, chain, dev) for k, fn in arms.items()}
        rec = {"shape": f"{batch}x{h}x{h}x{c}", "chain": chain, "iters": iters, "gop": gop,
               "ms": ms, "gop_s": {k: gop / v * 1e3 for k, v in ms.items()},
               "k3_mismatch": n_diff, "device": name}
        for k, v in ms.items():
            print(f"  {k:28s} {v:7.3f} ms/unit-batch  ({gop / v * 1e3:7.1f} GOP/s)", flush=True)
        if dev.type == "cuda":
            plan = plan_launch(batch, h, h, c, sm_count(dev), K3)
            bound, by = k3_bound(batch, h, c)
            rec.update(k3_plan=list(plan), k3_bound_ms=bound, k3_bound_by=by)
            print(f"  K3 plan {tuple(plan)} (the reference's strip={strip} has no "
                  f"meaning for it); bound {bound:.4f} ms ({by}), K3 at "
                  f"{bound / ms['k3']:.3f} of it", flush=True)
        rows.append(rec)
        del arms, xq, first
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--chain", type=int, default=24,
                    help="block applications chained inside one timed window")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="H,C,C2,strip tuples, e.g. 104,128,64,26")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.shapes or SHAPES, args.batch, args.chain, args.iters, args.device)
    print(json.dumps({"int8_block": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
