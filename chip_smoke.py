#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``amyloid_yolo_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. versions, and the card's name and power limit from ``nvidia-smi``;
2. build every kernel from ``amyloid_yolo_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel);
3. K1 (``resize_normalize``) against its plain version at B=4, 1536² → 416²:
   bit-exact;
4. K2 (``fused_residual_block``) against its plain version in bf16 at the
   five stage shapes of YOLOv3-416 (B=4), within one bf16 ulp;
5. the main path: ``Detector(conf_thres=0.3)`` at the full width of
   ``yolov3_spec(num_classes=2)``, 416 on 1536² tiles, random weights from a
   numpy seed carried over with ``params_from_jax``, 3 batches of 8 tiles.
   Launch counts must be 3 (K1) and 69 (K2); head maps through the kernels
   must match the plain path on the card; outputs finite, (8, 64, 7) and
   (8, 64);
6. timings on the card: the Detector call at B=8 and B=32 (tiles already
   on the card), a ``torch.profiler`` breakdown of its device time at B=8,
   and each kernel's time beside its plain version, a PyTorch library
   yardstick where one exists, and its bound (H100 SXM peaks: 989 TFLOP/s
   bf16, 3.35 TB/s);
7. one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

f32 references run with TF32 off.  It exits non-zero when CUDA is absent.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
STAGES = ((208, 64, 1), (104, 128, 2), (52, 256, 8), (26, 512, 8), (13, 1024, 4))
K2_RTOL, K2_ATOL = 2.0 ** -7, 2.0 ** -6      # one bf16 ulp, relative
HEAD_TOL = 5e-2                              # max |Δ| / max |plain| per head
SEED = 0


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, hold: bool = True) -> float:
    """Mean ms per call between CUDA events.  ``hold`` first queues a ~20 ms
    sleep on the stream, so the host enqueues every timed launch before the
    device reaches them: the result is device time, not the host's launch
    rate.  Without it (the Detector) the host's cost per call counts too."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(40_000_000)  # cycles, ~20 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profile_detector(det, tiles, calls: int = 3) -> dict:
    """Device time per call from a ``torch.profiler`` trace of ``calls``
    Detector calls: busy ms, the share of the traced span the device sat
    idle (the profiler's own host cost inflates it), and the launches and
    device ms of each kernel group (:func:`kernel_group`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            det(tiles)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return {"device_busy_ms": "not measured"}
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    span_us = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    groups = {}
    for e in events:
        g = groups.setdefault(kernel_group(e.name), [0, 0.0])
        g[0] += 1
        g[1] += e.time_range.elapsed_us()
    return {"device_busy_ms": busy_us / calls / 1e3,
            "idle_share_traced": 1.0 - busy_us / span_us,
            "launches_per_call": len(events) / calls,
            "by_group": {k: {"launches": n / calls, "ms": us / calls / 1e3}
                         for k, (n, us) in sorted(groups.items(), key=lambda kv: -kv[1][1])}}


def kernel_group(name: str) -> str:
    if "fused_residual_block" in name:
        return "K2 fused_residual_block"
    if "resize_normalize" in name:
        return "K1 resize_normalize"
    if any(s in name for s in ("xmma", "cutlass", "cudnn", "implicit_gemm", "conv")):
        return "cuDNN convolutions"
    if "elementwise" in name:
        return "elementwise"
    if "reduce" in name:
        return "reductions"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort"
    return "other"


def random_jax_params(spec, seed: int):
    """Reference-scheme weights (conv N(0, 0.02), BN scale N(1, 0.02)) with
    random BN shift and running stats, as the JAX package's numpy pytree."""
    import numpy as np
    rng = np.random.RandomState(seed)
    params = {}
    for i in spec.conv_indices:
        l = spec.layers[i]
        entry = {"w": (0.02 * rng.randn(l.kernel, l.kernel, l.in_ch, l.out_ch)).astype(np.float32)}
        if l.batch_normalize:
            n = l.out_ch
            params[f"bn_{i}"] = {
                "scale": (1.0 + 0.02 * rng.randn(n)).astype(np.float32),
                "bias": (0.1 * rng.randn(n)).astype(np.float32),
                "mean": (0.1 * rng.randn(n)).astype(np.float32),
                "var": (0.5 + rng.rand(n)).astype(np.float32),
            }
        else:
            entry["b"] = (0.1 * rng.randn(l.out_ch)).astype(np.float32)
        params[f"conv_{i}"] = entry
    return params


def k2_bound(b: int, h: int, c: int):
    flops = b * 20 * h * h * c * (c // 2)
    nbytes = b * 4 * h * h * c + 20 * c * (c // 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
    from amyloid_yolo_tpu_torch.io.weights import params_from_jax
    from amyloid_yolo_tpu_torch.kernels import _build, launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.kernels.conv_block import (
        fused_residual_block, fused_residual_block_plain)
    from amyloid_yolo_tpu_torch.kernels.preprocess_kernel import (
        resize_normalize, resize_normalize_plain)
    from amyloid_yolo_tpu_torch.models import darknet

    # 1. versions and card
    card = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. K1 against its plain version: bit-exact
    tiles4 = torch.randint(0, 256, (4, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    k1, k1_plain = resize_normalize(tiles4, 416), resize_normalize_plain(tiles4, 416)
    torch.cuda.synchronize()
    k1_err = (k1.float() - k1_plain.float()).abs().max().item()
    print(f"K1 resize_normalize B=4 1536->416: max|diff| {k1_err} (tolerance: bit-exact)")
    if not torch.equal(k1, k1_plain):
        raise AssertionError("K1 is not bit-exact to its plain version")

    # 4. K2 against its plain version at the five stage shapes
    def stage_inputs(b, h, c):
        c2 = c // 2
        x = torch.randn(b, h, h, c, device=dev, generator=gen).to(torch.bfloat16)
        w1t = (torch.randn(c2, c, device=dev, generator=gen) / c ** 0.5).to(torch.bfloat16)
        w2t = (torch.randn(9, c, c2, device=dev, generator=gen) / (9 * c2) ** 0.5).to(torch.bfloat16)
        b1 = 0.1 * torch.randn(c2, device=dev, generator=gen)
        b2 = 0.1 * torch.randn(c, device=dev, generator=gen)
        return x, w1t, b1, w2t, b2

    k2_err = 0.0
    for h, c, _ in STAGES:
        args = stage_inputs(4, h, c)
        y, r = fused_residual_block(*args), fused_residual_block_plain(*args)
        torch.cuda.synchronize()
        err = (y.float() - r.float()).abs().max().item()
        k2_err = max(k2_err, err)
        print(f"K2 fused_residual_block B=4 {h}x{h}x{c}: max|diff| {err} "
              f"(tolerance: rtol {K2_RTOL} atol {K2_ATOL}; max|plain| {r.float().abs().max().item()})")
        torch.testing.assert_close(y.float(), r.float(), rtol=K2_RTOL, atol=K2_ATOL)

    # 5. the main path
    spec = yolov3_spec(num_classes=2)
    params = params_from_jax(random_jax_params(spec, SEED), spec)
    det = Detector(spec, params, conf_thres=0.3)
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, 256, (8, 1536, 1536, 3)).astype(np.uint8) for _ in range(3)]
    reset_launch_counts()
    outs = []
    for tiles in batches:
        dets, valid = det(tiles)
        outs.append((dets, valid, det._last_ncand))
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"main path launches: {counts}", flush=True)
    if counts != {"resize_normalize": 3, "fused_residual_block": 69}:
        raise AssertionError(f"main path launch counts {counts}, want 3 and 69")
    for dets, valid, ncand in outs:
        if tuple(dets.shape) != (8, 64, 7) or tuple(valid.shape) != (8, 64):
            raise AssertionError(f"output shapes {tuple(dets.shape)} {tuple(valid.shape)}")
        if not torch.isfinite(dets).all():
            raise AssertionError("non-finite detections")
        det.account_overflow(n_cand=ncand)
        print(f"n_candidates {ncand.tolist()} valid {valid.sum(dim=1).tolist()}")
    print(f"overflow images {det.overflow_images} of {det.images_seen}")

    with torch.inference_mode():
        tiles = torch.from_numpy(batches[0]).to(dev)
        maps = det.head_maps(tiles)
        plain_maps = darknet.apply_folded(
            det.params, spec, resize_normalize_plain(tiles, 416),
            compute_dtype=torch.bfloat16, packs=det.packs,
            block_fn=fused_residual_block_plain)
    for m, p in zip(maps, plain_maps):
        rel = ((m - p).abs().max() / p.abs().max()).item()
        print(f"head {tuple(m.shape)}: max|kernel-plain| / max|plain| = {rel} "
              f"(tolerance {HEAD_TOL}); max|plain| {p.abs().max().item()}")
        if not (torch.isfinite(m).all() and rel <= HEAD_TOL):
            raise AssertionError("head maps through the kernels disagree with the plain path")

    # 6. timings
    detector = {}
    with torch.inference_mode():
        for b in (8, 32):
            tiles = torch.randint(0, 256, (b, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                                  generator=gen)
            ms = cuda_ms(lambda: det(tiles), iters=5, warmup=2, hold=False)
            detector[f"b{b}"] = {"ms_per_batch": ms, "tiles_per_s": b / ms * 1e3}
            print(f"Detector B={b} (tiles on the card): {ms:.3f} ms/batch, "
                  f"{b / ms * 1e3:.1f} tiles/s [{card}]", flush=True)

        tiles8 = torch.randint(0, 256, (8, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                               generator=gen)
        detector["b8"].update(profile_detector(det, tiles8))
        print(f"Detector B=8 device time by kernel: {json.dumps(detector['b8'])} [{card}]",
              flush=True)
        k1_ms = cuda_ms(lambda: resize_normalize(tiles8, 416))
        k1_plain_ms = cuda_ms(lambda: resize_normalize_plain(tiles8, 416))
        k1_bound = 8 * (416 * 1536 * 3 + 416 * 416 * 3 * 2) / PEAK_BYTES * 1e3
        print(f"K1 B=8: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
              f"bound {k1_bound:.4f} ms (bytes) [{card}]")

        stages = []
        for h, c, n in STAGES:
            x, w1t, b1, w2t, b2 = stage_inputs(8, h, c)
            ms = cuda_ms(lambda: fused_residual_block(x, w1t, b1, w2t, b2))
            plain_ms = cuda_ms(lambda: fused_residual_block_plain(x, w1t, b1, w2t, b2))
            xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
            w1c = w1t[:, :, None, None].contiguous(memory_format=torch.channels_last)
            w2c = w2t.reshape(3, 3, c, c // 2).permute(2, 3, 0, 1).contiguous(
                memory_format=torch.channels_last)
            hc = torch.randn(8, c // 2, h, h, device=dev, generator=gen).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            lib_ms = (cuda_ms(lambda: F.conv2d(xc, w1c))
                      + cuda_ms(lambda: F.conv2d(hc, w2c, padding=1)))
            bound, by = k2_bound(8, h, c)
            stages.append({"shape": f"8x{h}x{h}x{c}", "units": n, "ms": ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": bound, "bound_by": by})
            print(f"K2 B=8 {h}x{h}x{c}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"cuDNN 1x1+3x3 {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}) [{card}]",
                  flush=True)

    def total(key):
        return sum(s[key] * s["units"] for s in stages)

    ops_share = sum(s["bound_ms"] * s["units"] for s in stages if s["bound_by"] == "operations")
    kernels = [
        {"name": "resize_normalize", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/resize_normalize.cu",
         "replaces": "amyloid_yolo_tpu/pallas/preprocess_kernel.py:90",
         "launches": counts["resize_normalize"], "max_abs_err": k1_err,
         "max_abs_diff": k1_err, "tol": "bit-exact",
         "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None,
         "shape": "8x1536x1536x3 u8 -> 8x416x416x3 bf16"},
        {"name": "fused_residual_block", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/conv_block.cu",
         "replaces": "amyloid_yolo_tpu/pallas/conv_block.py:107",
         "launches": counts["fused_residual_block"], "max_abs_err": k2_err,
         "max_abs_diff": k2_err, "tol": f"rtol {K2_RTOL} atol {K2_ATOL}",
         "ms": total("ms"), "kernel_ms": total("ms"), "plain_ms": total("plain_ms"),
         "bound_ms": total("bound_ms"),
         "bound_by": "operations" if ops_share >= total("bound_ms") / 2 else "bytes",
         "library_ms": total("library_ms"),
         "shape": "the 23 units of one B=8 batch", "stages": stages},
    ]
    print(json.dumps({"detector": detector, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
