"""Steady-state train-step benchmark of the PyTorch port on one NVIDIA GPU
(``tools/bench_trainstep.py``'s counterpart).

Times the port's full micro-step (``parallel/steps.py:make_train_step``:
resize, augment, train forward, loss, backward, Adam), batch 8 at 416² by
default, from random weights (``darknet.init_params``, seed 0) on random
uint8 images already on the card.  One step first, then ``--iters`` steps
between CUDA events; the host's enqueue time of those steps is reported
beside.  Each step consumes the state the last one left, so the host cannot
run ahead of the device by more than PyTorch's queue.  ``--dtype f32``
runs with TF32 off (the step turns it off itself).

Per step configuration it prints the reference tool's line and one JSON
line (``batch``, ``size``, ``dtype``, ``tag``, ``ms_per_step``,
``img_per_s``, ``host_enqueue_ms``, ``device``).  ``--device cpu`` runs on
the CPU, host clock, with ``"device": "cpu"``.  With ``TRACE_DIR`` set it
also writes a ``torch.profiler`` Chrome trace of 4 steps there
(``tools/trace_summary_torch.py`` reads it).

Arms, as the reference tool's: ``--s2d-ab`` (standard against s2d stem),
``--layout-ab`` (NHWC against planar, both with the s2d stem),
``--forms-ab`` (``bn_form`` reduce against matmul), ``--batch-sweep`` (b8,
b16, b32 of planar + s2d), ``--warp-ab`` (the affine warp alone: the
three-shear warp against the exact bilinear warp,
``ops/augment.py:_affine_one``) and ``--warp`` (the three-shear warp
alone).  The reference's ``--warp-ab`` has a third arm, the 16-row grouped
shear, bit-exact to its per-row shear (``tests/test_augment.py:104``); the
port's shear gathers per row, so its one shear arm is that per-row form.
The reference's ``--forms-ab`` also crosses ``bn_form`` with its dense
``TARGETS_FORM``, a TPU form the port does not have (ROADMAP.md, "Not
ported, by rule").

Run on the card:  python tools/bench_trainstep_torch.py [--batch 8] [--size 416]
                  [--iters 30] [--dtype bf16|f32] [--s2d-ab | --layout-ab | ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _timed(fn, iters: int, dev):
    """``(ms per call, host enqueue ms per call)`` of ``iters`` calls of
    ``fn()``: CUDA events on the card, the host clock on the CPU (where
    ``fn`` returns a tensor read at the end)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters, host * 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    host = time.perf_counter() - t0
    float(out.sum())
    ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms, host * 1e3 / iters


WARPS = {"shear3": "_affine_shear3", "bilinear": "_affine_one"}


def bench_warp(B, S, iters, device="cuda", warp="shear3", label=None):
    """One affine warp alone (``WARPS``: the port's three-shear warp, or the
    exact bilinear warp) on B random S² float images, chained; ms a batch."""
    import torch
    from amyloid_yolo_tpu_torch.ops import augment as aug
    from amyloid_yolo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    fn = getattr(aug, WARPS[warp])
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(B, S, S, 3).astype(np.float32)).to(dev)
    ang, tx, ty = (torch.from_numpy(rng.uniform(lo, hi, B).astype(np.float32)).to(dev)
                   for lo, hi in ((-20, 20), (-0.2, 0.2), (-0.2, 0.2)))
    x = [fn(img, ang, tx, ty)]

    def once():
        x[0] = fn(x[0], ang, tx, ty)
        return x[0]

    dt, _ = _timed(once, iters, dev)
    print(f"  warp {label or warp:18s} {dt:7.2f} ms/batch (b{B}@{S}) [{_device_name(dev)}]")
    return dt


def bench_step(B, S, iters, dtype_name, bn_form=None, tag="", s2d_stem=False,
               image_layout="nhwc", device="cuda", spec=None) -> dict:
    import torch
    from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
    from amyloid_yolo_tpu_torch.models import darknet
    from amyloid_yolo_tpu_torch.parallel import steps
    from amyloid_yolo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    spec = spec or yolov3_spec()
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    params = darknet.init_params(torch.Generator().manual_seed(0), spec)
    opt = steps.make_optimizer(1e-4)
    state = steps.init_train_state(params, opt, device=dev)
    step = steps.make_train_step(spec, opt, augment=True, compute_dtype=dtype,
                                 s2d_stem=s2d_stem, image_layout=image_layout)

    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 256, (B, S, S, 3), dtype=np.uint8)).to(dev)
    T = 64
    t = np.zeros((T, 6), np.float32)
    t[:8] = [[i, 1, 0.5, 0.5, 0.1, 0.1] for i in range(8)]
    targets = torch.from_numpy(t).to(dev)
    mask = torch.from_numpy(np.arange(T) < 8).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def once():
        _, m = step(state, imgs, targets, mask, gen, S)
        return m["loss"]

    form = darknet.BN_FORM
    if bn_form is not None:
        darknet.BN_FORM = bn_form
    try:
        float(once())  # the first step: the allocator and cuDNN's choices
        dt, host = _timed(once, iters, dev)
        trace_dir = os.environ.get("TRACE_DIR")
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                             else [])
            with profile(activities=acts) as prof:
                for _ in range(4):
                    loss = once()
                float(loss)
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"trainstep_b{B}_{dtype_name}.json")
            prof.export_chrome_trace(path)
            print(f"trace written to {path}")
    finally:
        darknet.BN_FORM = form
    ips = B / dt * 1e3
    print(f"train step b{B}@{S} {dtype_name}{tag}: {dt:.2f} ms/step = "
          f"{ips:.1f} img/s/chip", flush=True)
    rec = {"batch": B, "size": S, "dtype": dtype_name, "tag": tag.strip(), "ms_per_step": dt,
           "img_per_s": ips, "host_enqueue_ms": host, "device": _device_name(dev)}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--warp-ab", action="store_true",
                    help="A/B the affine warp alone: three-shear (per row) vs bilinear")
    ap.add_argument("--warp", action="store_true",
                    help="time the port's three-shear warp alone")
    ap.add_argument("--s2d-ab", action="store_true",
                    help="A/B the s2d training stem vs the standard stem")
    ap.add_argument("--layout-ab", action="store_true",
                    help="A/B the planar image pipeline vs NHWC (both with the s2d stem)")
    ap.add_argument("--forms-ab", action="store_true",
                    help="A/B bn_form reduce vs matmul on the full train step")
    ap.add_argument("--batch-sweep", action="store_true",
                    help="b8/b16/b32 of planar + s2d stem in one process")
    ap.add_argument("--model_def", default=None,
                    help="darknet cfg to build the graph from (default: YOLOv3)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bench_torch import print_card
    from amyloid_yolo_tpu_torch.graphspec import from_cfg

    print_card(args.device)

    spec = from_cfg(args.model_def) if args.model_def else None
    kw = dict(device=args.device, spec=spec)
    B, S, n, dt = args.batch, args.size, args.iters, args.dtype
    if args.batch_sweep:
        res = {b: bench_step(b, S, n, dt, tag=" (planar+s2d)", s2d_stem=True,
                             image_layout="planar", **kw) for b in (8, 16, 32)}
        for b, r in res.items():
            print(f"  b{b:<3d} {r['ms_per_step']:7.2f} ms/step  {r['img_per_s']:7.1f} "
                  f"img/s/chip")
        return res
    if args.warp:
        bench_warp(B, S, n, args.device)
    if args.warp_ab:
        print("# the reference's shear3_grouped arm is bit-exact to its per-row shear; the "
              "port's shear gathers per row, so it is the one shear arm here",
              file=sys.stderr)
        bench_warp(B, S, n, args.device, label="shear3_per_row")
        bench_warp(B, S, n, args.device, warp="bilinear")
    if args.layout_ab:
        base = bench_step(B, S, n, dt, tag=" layout=nhwc", s2d_stem=True, **kw)
        planar = bench_step(B, S, n, dt, tag=" layout=planar", s2d_stem=True,
                            image_layout="planar", **kw)
        print(f"  planar pipeline: {base['ms_per_step']:.2f} -> {planar['ms_per_step']:.2f} "
              f"ms/step ({base['ms_per_step'] / planar['ms_per_step']:.3f}x)")
        return [base, planar]
    if args.s2d_ab:
        base = bench_step(B, S, n, dt, tag=" stem=standard", **kw)
        s2d = bench_step(B, S, n, dt, tag=" stem=s2d", s2d_stem=True, **kw)
        print(f"  s2d stem: {base['ms_per_step']:.2f} -> {s2d['ms_per_step']:.2f} ms/step "
              f"({base['ms_per_step'] / s2d['ms_per_step']:.3f}x)")
        return [base, s2d]
    if args.forms_ab:
        print("# the reference's targets=dense arms are left out: the port has the scatter "
              "targets form only (ROADMAP.md)", file=sys.stderr)
        results = {bn: bench_step(B, S, n, dt, bn_form=bn, tag=f" bn={bn}", **kw)
                   for bn in ("reduce", "matmul")}
        base = results["reduce"]["ms_per_step"]
        for bn, r in results.items():
            print(f"  bn={bn:6s} {r['ms_per_step']:7.2f} ms/step "
                  f"({base / r['ms_per_step']:.2f}x vs the default)")
        return results
    return bench_step(B, S, n, dt, **kw)


if __name__ == "__main__":
    main()
