"""A/B of the train-mode BN statistics' two forms on one NVIDIA GPU
(``tools/bench_bn_stats.py``'s counterpart).

For every batch-normalised conv output of ``yolov3_spec`` at (batch, size),
as the train forward holds it (NCHW, channels-last memory, ``--dtype``), it
runs the four sums of each BN layer (forward ``Σx``, ``Σx²``; backward
``Σdy``, ``Σdy·x``) in the port's two forms, forward and backward over the
whole shape set:

  reduce   ``models/darknet.py:bn_batch_moments`` and the inline normalize,
           autograd's backward (``bn_form="reduce"``, the default)
  matmul   ``bn_batch_moments_matmul`` and ``ops/bnstats.py:bn_normalize``,
           whose backward takes its sums as products (``bn_form="matmul"``)

Per form: the wall time a fwd+bwd iteration between CUDA events, and the
device time from a ``torch.profiler`` trace of one iteration (a warm-up
iteration first, its events dropped) with the six largest kernels; the
trace must keep a device record for each launch call of the host, and is
taken again until it does (``trace_summary_torch.checked_trace``).  Then
the two forms' losses side by side.  One JSON line per form (``form``,
``wall_ms``, ``device_ms``, ``trace_tries``: ``[records, launch calls]``
of each trace, ``layers``, ``loss``, ``device``).  ``--device
cpu`` runs on the CPU: host clock, no device time ("not measured").

The end-to-end A/B is ``tools/bench_trainstep_torch.py --forms-ab``.

Run on the card:  python tools/bench_bn_stats_torch.py [--batch 8] [--size 416] [--iters 20]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DTYPES = ("bfloat16", "float32")


def bn_shapes(spec, batch: int, size: int):
    """(B, C, H, W) of every batch-normalised conv output of ``spec``."""
    from amyloid_yolo_tpu_torch.graphspec import (ConvSpec, MaxPoolSpec, RouteSpec,
                                                  UpsampleSpec)
    shapes, outs = [], []
    hw, ch = size, 3
    for layer in spec.layers:
        if isinstance(layer, ConvSpec):
            hw = (hw + 2 * layer.pad - layer.kernel) // layer.stride + 1
            ch = layer.out_ch
            if layer.batch_normalize:
                shapes.append((batch, ch, hw, hw))
        elif isinstance(layer, MaxPoolSpec):
            hw //= layer.stride
        elif isinstance(layer, UpsampleSpec):
            hw *= layer.factor
        elif isinstance(layer, RouteSpec):
            hw = outs[layer.layers[0]][0]
            ch = sum(outs[s][1] for s in layer.layers)
        outs.append((hw, ch))
    return shapes


def make_loss(form: str, gammas, betas):
    """Σ over the layers of Σ BN(x)² in float32, BN in ``form``."""
    import torch
    from amyloid_yolo_tpu_torch.models import darknet
    from amyloid_yolo_tpu_torch.ops import bnstats

    def layer(x, g, b):
        if form == "matmul":
            mean, var, _ = darknet.bn_batch_moments_matmul(x)
            return bnstats.bn_normalize(x, mean, torch.rsqrt(var + darknet.BN_EPS), g, b)
        x32 = x.to(torch.float32)
        mean, var, _ = darknet.bn_batch_moments(x32)
        k = g * torch.rsqrt(var + darknet.BN_EPS)
        return ((x32 - mean[None, :, None, None]) * k[None, :, None, None]
                + b[None, :, None, None]).to(x.dtype)

    def loss(xs):
        tot = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for x, g, b in zip(xs, gammas, betas):
            tot = tot + (layer(x, g, b).to(torch.float32) ** 2).sum()
        return tot

    return loss


def device_time(fn, dev, top: int = 6):
    """Device ms of one ``fn()`` from a ``torch.profiler`` trace (a warm-up
    call first, its events dropped: tracing starts late on the card) that
    kept a device record for each launch call, its ``top`` kernels by
    device ms, and ``[records, launch calls]`` of each trace taken."""
    import torch
    from torch.profiler import ProfilerActivity
    if dev.type != "cuda":
        return "not measured", [], "not measured"
    from trace_summary_torch import checked_trace, warmed_profile

    def take():
        with warmed_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
        return prof

    prof, tries = checked_trace(take)
    tot = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            tot[e.name[:90]] += e.time_range.elapsed_us()
    return (sum(tot.values()) / 1e3, [(k, us / 1e3) for k, us in tot.most_common(top)],
            tries)


def run(batch: int, size: int, iters: int, dtype: str = "bfloat16", device="cuda",
        spec=None) -> dict:
    import torch
    from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
    from amyloid_yolo_tpu_torch.utils.device import no_tf32, resolve_device

    dev = resolve_device(device)
    spec = spec or yolov3_spec()
    shapes = bn_shapes(spec, batch, size)
    dt = getattr(torch, dtype)
    print(f"{len(shapes)} BN activations at b{batch}@{size}, "
          f"{sum(int(np.prod(s)) for s in shapes) * dt.itemsize / 2**20:.0f} MB total "
          f"({dtype})", flush=True)
    # the activations drawn on the device (~0.2 G values at B=8, 416²), the
    # per-channel vectors from numpy, with the reference tool's scales
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [(torch.randn(s, generator=gen, device=dev) * 0.5 + 0.1).to(dt)
          .contiguous(memory_format=torch.channels_last).requires_grad_(True) for s in shapes]
    rng = np.random.RandomState(0)
    gammas = [torch.from_numpy(rng.rand(s[1]).astype(np.float32) + 0.5).to(dev) for s in shapes]
    betas = [torch.from_numpy(rng.randn(s[1]).astype(np.float32) * 0.1).to(dev)
             for s in shapes]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {}
    with no_tf32() if dev.type == "cuda" else contextlib.nullcontext():
        for form in ("reduce", "matmul"):
            loss = make_loss(form, gammas, betas)

            def fwd_bwd():
                return torch.autograd.grad(loss(xs), xs)

            fwd_bwd()
            wall = _wall_ms(fwd_bwd, iters, dev)
            dev_ms, top, tries = device_time(fwd_bwd, dev)
            with torch.no_grad():
                value = float(loss(xs))
            rec = {"form": form, "wall_ms": wall, "device_ms": dev_ms, "trace_tries": tries,
                   "layers": len(shapes), "loss": value, "device": name}
            shown = f"{dev_ms:7.2f}" if isinstance(dev_ms, float) else dev_ms
            print(f"{form:8s} wall {wall:7.2f} ms/iter   device {shown} ms  (fwd stats + "
                  f"normalize + full bwd, {len(shapes)} layers; [records, launch calls] of "
                  f"each trace {tries})", flush=True)
            for kname, ms in top:
                print(f"          {ms:8.3f} ms  {kname}")
            print(json.dumps(rec), flush=True)
            out[form] = rec
    lr, lm = out["reduce"]["loss"], out["matmul"]["loss"]
    print(f"loss reduce={lr:.6e} matmul={lm:.6e} rel={abs(lr - lm) / abs(lr):.2e}", flush=True)
    return out


def _wall_ms(fn, iters: int, dev) -> float:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    ap.add_argument("--model_def", default=None,
                    help="darknet cfg to take the BN shapes from (default: YOLOv3)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench_torch import print_card
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    print_card(args.device)
    spec = from_cfg(args.model_def) if args.model_def else None
    return run(args.batch, args.size, args.iters, args.dtype, args.device, spec)


if __name__ == "__main__":
    main()
