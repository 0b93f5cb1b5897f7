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
   five stage shapes of YOLOv3-416 and a ragged unit (20², 128 channels),
   at B=1, 4, 8 and 32 (the tiling depends on B: 8 and 32 are the batches
   phases 6 and 9 run), within one bf16 ulp; each launch plan's shared memory
   from Python (``smem_bytes``) must equal the C side's, and its blocks per
   SM the ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` count;
5. K3 (``fused_residual_block_int8``) against its plain version at the five
   stage shapes and the ragged unit, at B=1, 4, 8 and 32 (its tiling, too,
   depends on B), random int8 inputs with the reference tool's weight and
   scale ranges (``tools/bench_int8_block.py``): bit-exact; shared memory
   and blocks per SM of each plan, Python against C, as in phase 4;
6. the main path: ``Detector(conf_thres=0.3)`` at the full width of
   ``yolov3_spec(num_classes=2)``, 416 on 1536² tiles, random weights from a
   numpy seed carried over with ``params_from_jax``, 3 batches of 8 tiles.
   Launch counts must be 3 (K1), 69 (K2) and 0 (K3); head maps through the
   kernels must match the plain path on the card; outputs finite, (8, 64, 7)
   and (8, 64);
7. the int8 Detectors, ``precision="int8_full"`` and ``"int8_early"``, on
   the same weights, calibrated on the first batch, then 3 batches of 8:
   launch counts 3 (K1), 0 (K2), 0 (K3); outputs finite and shaped as
   above; the ``int8_full`` head maps of one tile on the card against the
   CPU with the same scales (through a calibration sidecar), within
   ``HEAD_TOL``; and the unfolded bf16 ``Detector(fold_bn=False)`` on one
   batch: launches 1/0/0, outputs finite and shaped;
8. K3's path: the 23 residual units of the calibrated ``int8_full`` model
   (``pack_model_int8_units``), chained stage by stage from a random int8
   stage input at B=8: 23 launches, each unit bit-exact against the plain
   version; then the same chain at B=4, bit-exact;
9. timings on the card: the three Detectors at B=8 and B=32 (tiles already
   on the card), a ``torch.profiler`` breakdown of the bf16 and
   ``int8_full`` device time at B=8, and each kernel's time beside its plain
   version, a PyTorch library yardstick where one exists, and its bound
   (H100 SXM peaks: 989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s); K2 and
   K3 per stage at B=8 and B=32 with their launch plans (grid, blocks per
   SM, waves, executed-work ratio) and achieved TFLOP/s or TOP/s;
10. the folder path (``Detector.detect_folder``, the path of ``detect``): a
   temporary folder that PIL writes (37 synthetic stain tiles of 1536², one
   1536×1000 border tile, two near-blank tiles, one corrupt ``.jpg``); the
   decoder is the port's native tile reader where the libjpeg headers are
   present (then it must build) and PIL where they are absent.  The bf16
   Detector of phase 6 runs ``detect_folder(batch_size=8, merge_boxes=True,
   caa_filter=CAAFilter(...).filter_path)`` with a random classifier from a
   numpy seed: K1 launches = K2 launches / 23 = the batch count; every
   readable path in the result, the corrupt one reported and absent; the
   border tile's boxes in its own pixels; the result equal, box for box, to
   an explicit recomputation (reader, ``Detector.__call__``,
   ``dense_to_ragged``, ``rescale_from_tile_frame``, ``merge_detections``,
   the filter); the classifier on the card within ``CAA_TOL`` of its CPU
   float32 run; ``background_skip=True`` returns the blank tiles as
   ``None``; an ``int8_full`` Detector calibrates from the folder and its
   sidecar records the 40 readable tiles.  Then tiles/s of
   ``detect_folder`` at B=8 and B=32 from the JPEGs on disk to the filtered
   boxes, beside the reader alone and ``Detector.__call__`` on the same
   tiles already on the card, and a ``torch.profiler`` trace of one B=8
   folder run for the device's busy time and idle share;
11. one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

f32 references run with TF32 off.  It exits non-zero when CUDA is absent.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
STAGES = ((208, 64, 1), (104, 128, 2), (52, 256, 8), (26, 512, 8), (13, 1024, 4))
DETECTOR_BATCHES = (8, 32)                   # phases 6 (the first) and 9
CHECK_BATCHES = (1, 4) + DETECTOR_BATCHES  # K2's and K3's plans depend on B
RAGGED_UNIT = (20, 128)                    # H = W = 20: no tile size divides it
K2_RTOL, K2_ATOL = 2.0 ** -7, 2.0 ** -6      # one bf16 ulp, relative
HEAD_TOL = 5e-2                              # max |Δ| / max |plain| per head
SEED = 0
K3_SCALES = (0.011, 0.017, 0.023)            # sx, s1, s_out of the reference tool
CAA_TOL = 1e-3                               # classifier probabilities, card vs CPU f32
FOLDER = dict(n_tiles=37, side=1536, border=(1000, 1536), blank=2)


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
    groups, names = {}, {}
    for e in events:
        for table, key in ((groups, kernel_group(e.name)), (names, e.name[:90])):
            g = table.setdefault(key, [0, 0.0])
            g[0] += 1
            g[1] += e.time_range.elapsed_us()

    def per_call(table, n=None):
        rows = sorted(table.items(), key=lambda kv: -kv[1][1])[:n]
        return {k: {"launches": c / calls, "ms": us / calls / 1e3} for k, (c, us) in rows}

    return {"device_busy_ms": busy_us / calls / 1e3,
            "idle_share_traced": 1.0 - busy_us / span_us,
            "launches_per_call": len(events) / calls,
            "by_group": per_call(groups), "top_kernels": per_call(names, 6)}


def kernel_group(name: str) -> str:
    if "fused_residual_block_int8" in name:
        return "K3 fused_residual_block_int8"
    if "fused_residual_block" in name:
        return "K2 fused_residual_block"
    if "resize_normalize" in name:
        return "K1 resize_normalize"
    if any(s in name for s in ("fprop", "implicit_gemm", "cudnn", "conv")):
        return "cuDNN convolutions"
    if any(s in name.lower() for s in ("gemm", "imma", "xmma", "cutlass")):
        return "GEMMs (int8 _int_mm; cuDNN 1x1 convs as GEMMs)"
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


def k2_stage_inputs(b, h, c, dev, gen):
    """Random bf16 unit at (b, h, h, c): x ~ N(0, 1), weights of variance
    1/fan-in, f32 biases 0.1·N(0, 1); (x, w1t, b1, w2t, b2) in the kernel's
    layouts."""
    import torch
    c2 = c // 2
    x = torch.randn(b, h, h, c, device=dev, generator=gen).to(torch.bfloat16)
    w1t = (torch.randn(c2, c, device=dev, generator=gen) / c ** 0.5).to(torch.bfloat16)
    w2t = (torch.randn(9, c, c2, device=dev, generator=gen) / (9 * c2) ** 0.5).to(torch.bfloat16)
    b1 = 0.1 * torch.randn(c2, device=dev, generator=gen)
    b2 = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, w1t, b1, w2t, b2


def detector_ms(det, b, dev, gen) -> float:
    """ms per call of ``det`` on b random uint8 1536² tiles already on the
    card: 5 calls after 2, host cost included."""
    import torch
    tiles = torch.randint(0, 256, (b, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                          generator=gen)
    with torch.inference_mode():
        return cuda_ms(lambda: det(tiles), iters=5, warmup=2, hold=False)


def k3_bound(b: int, h: int, c: int):
    ops = b * 20 * h * h * c * (c // 2)
    nbytes = b * 2 * h * h * c + 10 * c * (c // 2)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k3_stage_inputs(b, h, c, dev, gen):
    """Random int8 unit at (b, h, h, c) with the reference tool's ranges:
    weights uniform in ±127, weight scales in [1e-3, 2e-2), biases in ±1."""
    import torch
    from amyloid_yolo_tpu_torch.kernels.int8_block import pack_int8_block
    c2 = c // 2
    sx, s1, _ = K3_SCALES

    def ri(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)

    def ru(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, device=dev, generator=gen)

    w1t, ws1, b1, w2t, ws2, b2 = pack_int8_block(
        ri(c2, c, 1, 1), ru(1e-3, 2e-2, c2), ru(-1, 1, c2),
        ri(c, c2, 3, 3), ru(1e-3, 2e-2, c), ru(-1, 1, c))
    return ri(b, h, h, c), (w1t, ws1 * sx, b1, w2t, ws2 * s1, b2)


def libjpeg_present() -> bool:
    """Whether ``g++`` compiles and links a program against libjpeg, which
    is what the port's tile reader needs to build."""
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cxx, "-x", "c++", "-", "-o", os.path.join(tmp, "probe"), "-ljpeg"],
            input="#include <cstdio>\n#include <jpeglib.h>\n"
                  "int main() { jpeg_error_mgr e; return jpeg_std_error(&e) == nullptr; }\n",
            capture_output=True, text=True, timeout=120)
    return proc.returncode == 0


def stain_tile(rng, h: int, w: int):
    """A smooth synthetic stained-tissue tile, uint8 (h, w, 3): dark stain
    blobs over a bright background at quarter resolution, upsampled, plus
    grain, so its JPEG has a real tile's size (0.1-1 MB at 1536²)."""
    import numpy as np
    hq, wq = -(-h // 4), -(-w // 4)
    yy, xx = np.mgrid[0:hq, 0:wq] / float(max(hq, wq))
    img = np.full((hq, wq, 3), 236.0)
    for _ in range(10):
        cy, cx = rng.rand(2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(0.002, 0.03))
        img -= blob[..., None] * rng.uniform([50, 80, 100], [110, 150, 170])
    img = np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)[:h, :w]
    img += rng.randint(-5, 6, (h, w, 1))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_folder(folder: str, seed: int, n_tiles: int, side: int, border, blank: int):
    """The phase-10 folder; returns (readable paths, border path, blank
    paths, corrupt path)."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    tiles = [os.path.join(folder, f"t{i:03d}.jpg") for i in range(n_tiles)]
    for p in tiles:
        Image.fromarray(stain_tile(rng, side, side)).save(p, quality=90)
    border_p = os.path.join(folder, "u_border.jpg")
    Image.fromarray(stain_tile(rng, *border)).save(border_p, quality=90)
    blanks = [os.path.join(folder, f"v_blank{i}.jpg") for i in range(blank)]
    for p in blanks:
        img = np.full((side, side, 3), 243, np.uint8) + rng.randint(0, 3, (side, side, 1)).astype(np.uint8)
        Image.fromarray(img).save(p, quality=90)
    corrupt = os.path.join(folder, "c_bad.jpg")
    with open(corrupt, "wb") as fh:
        fh.write(b"not a jpeg")
    return sorted(tiles + [border_p] + blanks), border_p, blanks, corrupt


def random_classifier_params(seed: int):
    """The CAA classifier's weights in the reference package's layout
    (numpy): He-normal HWIO convs, random BN statistics, a linear layer
    N(0, 0.01²)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    params, in_ch = {}, 3
    for i, w in enumerate((16, 32, 48, 64, 80, 96)):
        params[f"conv_{i}"] = {
            "w": (rng.randn(3, 3, in_ch, w) * np.sqrt(2.0 / (9 * in_ch))).astype(np.float32),
            "b": (0.05 * rng.randn(w)).astype(np.float32)}
        params[f"bn_{i}"] = {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32),
                             "bias": (0.1 * rng.randn(w)).astype(np.float32),
                             "mean": (0.05 * rng.randn(w)).astype(np.float32),
                             "var": (0.5 + rng.rand(w)).astype(np.float32)}
        in_ch = w
    params["fc"] = {"w": (0.01 * rng.randn(96 * 16, 3)).astype(np.float32),
                    "b": np.zeros(3, np.float32)}
    return params


def recompute_folder(det, folder: str, batch_size: int, caa):
    """``detect_folder(merge_boxes=True, caa_filter=caa.filter_path)``
    spelled out, one stage after another: the reader, ``Detector.__call__``,
    ``dense_to_ragged``, ``rescale_from_tile_frame``, ``merge_detections``,
    the filter.  Returns (results, batches, host seconds per stage)."""
    from amyloid_yolo_tpu_torch.io.datasets import ImageFolder
    from amyloid_yolo_tpu_torch.ops.boxes import rescale_from_tile_frame
    from amyloid_yolo_tpu_torch.ops.merge import merge_detections
    from amyloid_yolo_tpu_torch.ops.nms import dense_to_ragged
    ds = ImageFolder(folder, tile_size=det.tile_size)
    out, n_batches = {}, 0
    secs = {"waiting for the reader": 0.0, "Detector call + dense_to_ragged": 0.0,
            "rescale + merge": 0.0, "CAA filter (decode + crops + classifier)": 0.0}
    stages = list(secs)
    batches = ds.iter_batches(batch_size)
    while True:
        t0 = time.perf_counter()
        item = next(batches, None)
        t1 = time.perf_counter()
        secs[stages[0]] += t1 - t0
        if item is None:
            break
        paths, batch, n_valid = item
        n_batches += 1
        ragged = dense_to_ragged(*det(batch))
        secs[stages[1]] += time.perf_counter() - t1
        for p, d in list(zip(paths, ragged))[:n_valid]:
            if d is not None:
                t0 = time.perf_counter()
                d = merge_detections(rescale_from_tile_frame(d, det.tile_size,
                                                             ds.orig_shapes[p]))
                t1 = time.perf_counter()
                d = caa.filter_path(p, d)
                secs[stages[2]] += t1 - t0
                secs[stages[3]] += time.perf_counter() - t1
                d = d if len(d) else None
            out[p] = d
    return out, n_batches, secs


def folder_phase(det, spec, params, card: str) -> dict:
    """Phase 10 (see the module docstring); returns its JSON record."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.domain import CAAFilter, _crop
    from amyloid_yolo_tpu_torch.io import native
    from amyloid_yolo_tpu_torch.io.datasets import ImageFolder, load_image_rgb
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.models import classifier

    record = {}
    if libjpeg_present():
        t0 = time.perf_counter()
        if not native.available():
            raise AssertionError("libjpeg is present but the port's tile reader did not build")
        record["decoder"] = "native"
        print(f"decoder: native (amyloid_yolo_tpu_torch/csrc/tile_reader.cc, built and "
              f"loaded in {time.perf_counter() - t0:.2f} s)", flush=True)
    else:
        record["decoder"] = "pil"
        print("decoder: pil (no libjpeg headers or library for g++ on this machine)",
              flush=True)
    cparams = classifier.from_jax_params(random_classifier_params(SEED))
    caa = CAAFilter(cparams)
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        readable, border, blanks, corrupt = write_folder(folder, SEED, **FOLDER)
        sizes = [os.path.getsize(p) for p in readable]
        print(f"folder: {len(readable)} readable tiles + 1 corrupt written in "
              f"{time.perf_counter() - t0:.2f} s; JPEG sizes {min(sizes)}-{max(sizes)} B, "
              f"median {int(np.median(sizes))} B", flush=True)

        # the run, with its launch counts and the reader's report
        log = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(log):
            res = det.detect_folder(folder, batch_size=8, merge_boxes=True,
                                    caa_filter=caa.filter_path)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(log.getvalue().strip())
        print(f"detect_folder B=8 launches: {counts}", flush=True)
        with contextlib.redirect_stdout(io.StringIO()):
            want, n_batches, secs = recompute_folder(det, folder, 8, caa)
        record["recompute_b8_host_s"] = secs
        print(f"recomputation B=8, host seconds by stage (run in turn, the reader "
              f"decoding ahead): {json.dumps({k: round(v, 4) for k, v in secs.items()})} "
              f"[{card}]", flush=True)
        if counts != {"resize_normalize": n_batches, "fused_residual_block": 23 * n_batches,
                      "fused_residual_block_int8": 0}:
            raise AssertionError(f"detect_folder launches {counts} over {n_batches} batches")
        if sorted(res) != readable:
            raise AssertionError(f"result keys {sorted(res)} are not the readable tiles")
        if corrupt in res or not ("Could not read image" in log.getvalue()
                                  and corrupt in log.getvalue()):
            raise AssertionError("the corrupt file was not reported and left out")
        if sorted(want) != sorted(res) or any(
                (want[p] is None) != (res[p] is None)
                or (res[p] is not None and not np.array_equal(res[p], want[p])) for p in res):
            raise AssertionError("detect_folder differs from its explicit recomputation")
        rows = [len(v) for v in res.values() if v is not None]
        n_caa = sum(int((v[:, 6] == 0).sum()) for v in res.values() if v is not None)
        print(f"detect_folder = recomputation, box for box: {len(res)} tiles, "
              f"{sum(rows)} boxes after merge and filter ({n_caa} CAA), "
              f"{sum(v is None for v in res.values())} tiles without boxes", flush=True)
        b = res[border]
        if b is not None:
            h, w = FOLDER["border"]
            pad = (w - h) // 2
            cx, cy = (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2
            if not ((cx >= 0).all() and (cx <= w).all() and (cy >= -pad).all()
                    and (cy <= h + pad).all()):
                raise AssertionError("border boxes are not in the border tile's own pixels")
            print(f"border tile {h}x{w}: {len(b)} boxes, centres x {cx.min():.1f}-"
                  f"{cx.max():.1f}, y {cy.min():.1f}-{cy.max():.1f} (its own pixels; the "
                  f"padded square spans y -{pad}..{h + pad})")

        # the classifier on the card against its CPU float32 run
        img = load_image_rgb(readable[0])
        rng = np.random.RandomState(SEED)
        xy = rng.randint(0, det.tile_size, (8, 2))
        crops = np.stack([_crop(img, np.array([x, y, x + 64, y + 64], np.float32))
                          for x, y in xy])
        p_card = caa.predict_crops(crops)
        p_cpu = CAAFilter(cparams, device="cpu").predict_crops(crops)
        caa_err = float(np.abs(p_card - p_cpu).max())
        print(f"CAA classifier card vs CPU f32 on 8 crops: max|diff| {caa_err} "
              f"(tolerance {CAA_TOL}); p(CAA) {np.round(p_cpu[:, 2], 4).tolist()}", flush=True)
        if caa_err > CAA_TOL:
            raise AssertionError("the CAA classifier on the card disagrees with the CPU")

        skipped = det.detect_folder(folder, batch_size=8, background_skip=True)
        if sorted(skipped) != readable or any(skipped[p] is not None for p in blanks):
            raise AssertionError("background_skip did not return the blank tiles as None")
        print(f"background_skip: {[os.path.basename(p) for p in blanks]} -> None", flush=True)

        d8 = Detector(spec, params, conf_thres=0.3, precision="int8_full")
        reset_launch_counts()
        res8 = d8.detect_folder(folder, batch_size=8)
        torch.cuda.synchronize()
        counts8 = launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            with open(d8.save_calibration(os.path.join(tmp, "int8_full.json"))) as fh:
                meta = json.load(fh)["meta"]
        print(f"int8_full detect_folder: launches {counts8}, {len(res8)} tiles; calibration "
              f"meta {meta}", flush=True)
        if meta["n_tiles"] != len(readable) or meta["source"] != "folder" or sorted(res8) != readable:
            raise AssertionError("int8_full did not calibrate on the folder's readable tiles")
        if counts8["fused_residual_block"] or counts8["fused_residual_block_int8"]:
            raise AssertionError(f"int8_full launched K2 or K3: {counts8}")
        del d8

        # timings: from the JPEGs on disk to the filtered boxes
        n = len(readable)
        record.update({"tiles": n, "batches_b8": n_batches, "caa_err": caa_err,
                       "launches_b8": counts})
        for bs in DETECTOR_BATCHES:
            reader_s = []
            for _ in range(2):
                with contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    batches = list(ImageFolder(folder, tile_size=det.tile_size).iter_batches(bs))
                    reader_s.append(time.perf_counter() - t0)
            folder_s = []
            for _ in range(2):
                with contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    det.detect_folder(folder, batch_size=bs, merge_boxes=True,
                                      caa_filter=caa.filter_path)
                    torch.cuda.synchronize()
                    folder_s.append(time.perf_counter() - t0)
            on_card = [torch.from_numpy(b).cuda() for _, b, _ in batches]
            with torch.inference_mode():
                call_ms = sum(cuda_ms(lambda: det(t), iters=5, warmup=2, hold=False)
                              for t in on_card)
            best = min(folder_s)
            record[f"b{bs}"] = {
                "folder_s": folder_s, "folder_tiles_per_s": [n / t for t in folder_s],
                "reader_s": reader_s, "reader_tiles_per_s": [n / t for t in reader_s],
                "call_ms_on_card": call_ms, "call_tiles_per_s": n / call_ms * 1e3,
                "host_share": 1.0 - call_ms / 1e3 / best}
            print(f"detect_folder B={bs} ({record['decoder']} decoder, merge + CAA filter, "
                  f"{n} tiles, {len(on_card)} batches): {[round(t, 3) for t in folder_s]} s = "
                  f"{[round(n / t, 1) for t in folder_s]} tiles/s; reader alone "
                  f"{[round(n / t, 1) for t in reader_s]} tiles/s; Detector.__call__ on the "
                  f"same tiles on the card {call_ms:.2f} ms = {n / call_ms * 1e3:.1f} tiles/s; "
                  f"host share {record[f'b{bs}']['host_share']:.4f} [{card}]", flush=True)
            del on_card, batches

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                det.detect_folder(folder, batch_size=8, merge_boxes=True,
                                  caa_filter=caa.filter_path)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        groups = {}
        for e in events:
            g = groups.setdefault("copies and fills" if "Mem" in e.name[:6]
                                  else kernel_group(e.name), [0, 0.0])
            g[0] += 1
            g[1] += e.time_range.elapsed_us() / 1e3
        record["traced_b8"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1.0 - busy_ms / wall_ms,
                               "device_launches": len(events),
                               "by_group": {k: {"launches": c, "ms": ms}
                                            for k, (c, ms) in sorted(groups.items())}}
        print(f"detect_folder B=8 traced: wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms "
              f"in {len(events)} launches, idle share {1.0 - busy_ms / wall_ms:.4f}; by group "
              f"{json.dumps(record['traced_b8']['by_group'])} [{card}]", flush=True)
    return record


def drive(det, batches, want_counts: dict) -> None:
    """One Detector over the batches with the launch counters set to 0
    just before: the counts must be ``want_counts``, the outputs finite
    and shaped (B, 64, 7) and (B, 64)."""
    import torch
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    outs = []
    for tiles in batches:
        dets, valid = det(tiles)
        outs.append((dets, valid, det._last_ncand))
    torch.cuda.synchronize()
    counts = launch_counts()
    name = det.precision if det.fold_bn else "unfolded bf16"
    print(f"{name} Detector launches: {counts}", flush=True)
    if counts != want_counts:
        raise AssertionError(f"{name} launch counts {counts}, want {want_counts}")
    for (dets, valid, ncand), tiles in zip(outs, batches):
        b = len(tiles)
        if tuple(dets.shape) != (b, 64, 7) or tuple(valid.shape) != (b, 64):
            raise AssertionError(f"output shapes {tuple(dets.shape)} {tuple(valid.shape)}")
        if not torch.isfinite(dets).all():
            raise AssertionError("non-finite detections")
        det.account_overflow(n_cand=ncand)
        print(f"n_candidates {ncand.tolist()} valid {valid.sum(dim=1).tolist()}")
    print(f"overflow images {det.overflow_images} of {det.images_seen}")


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
    from amyloid_yolo_tpu_torch.kernels import conv_block
    from amyloid_yolo_tpu_torch.kernels.conv_block import (
        K2, blocks_per_sm, fused_residual_block, fused_residual_block_plain, plan_launch,
        plan_stats, unit_flops)
    from amyloid_yolo_tpu_torch.kernels import int8_block
    from amyloid_yolo_tpu_torch.kernels.int8_block import (
        K3, fused_residual_block_int8, fused_residual_block_int8_plain, pack_model_int8_units)
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

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
    def checked_plan(b, h, c, kernel):
        """The launch plan of K2 or K3, its statistics, and the C side's
        blocks per SM; Python's and C's shared memory and blocks per SM must
        agree."""
        lib = int8_block if kernel is K3 else conv_block
        plan = plan_launch(b, h, h, c, sms, kernel)
        stats = plan_stats(b, h, h, c, plan, sms, kernel)
        c_smem = lib.c_smem_bytes(h, h, c, plan)
        c_bps = lib.c_blocks_per_sm(c, plan, stats.smem)
        if c_smem != stats.smem or c_bps != blocks_per_sm(stats.smem, plan):
            raise AssertionError(f"{kernel.name} plan {plan} at B={b} {h}x{h}x{c}: shared "
                                 f"memory {stats.smem} (Python) vs {c_smem} (C), blocks "
                                 f"per SM {blocks_per_sm(stats.smem, plan)} vs {c_bps}")
        return plan, stats, c_bps

    k2_err = 0.0
    for b in CHECK_BATCHES:
        for h, c in [s[:2] for s in STAGES] + [RAGGED_UNIT]:
            plan, stats, _ = checked_plan(b, h, c, K2)
            args = k2_stage_inputs(b, h, c, dev, gen)
            y, r = fused_residual_block(*args), fused_residual_block_plain(*args)
            torch.cuda.synchronize()
            err = (y.float() - r.float()).abs().max().item()
            k2_err = max(k2_err, err)
            print(f"K2 fused_residual_block B={b} {h}x{h}x{c}: max|diff| {err} "
                  f"(tolerance: rtol {K2_RTOL} atol {K2_ATOL}; max|plain| "
                  f"{r.float().abs().max().item()}); plan {tuple(plan)}, shared memory "
                  f"{stats.smem} B (Python = C)")
            torch.testing.assert_close(y.float(), r.float(), rtol=K2_RTOL, atol=K2_ATOL)
            del args, y, r

    # 5. K3 against its plain version at the five stage shapes: bit-exact
    sx, s1, s_out = K3_SCALES
    k3_err = 0
    for b in CHECK_BATCHES:
        for h, c in [s[:2] for s in STAGES] + [RAGGED_UNIT]:
            plan, stats, _ = checked_plan(b, h, c, K3)
            xq, pack = k3_stage_inputs(b, h, c, dev, gen)
            y = fused_residual_block_int8(xq, *pack, sx=sx, s1=s1, s_out=s_out)
            r = fused_residual_block_int8_plain(xq, *pack, sx=sx, s1=s1, s_out=s_out)
            torch.cuda.synchronize()
            err = (y.int() - r.int()).abs().max().item()
            k3_err = max(k3_err, err)
            print(f"K3 fused_residual_block_int8 B={b} {h}x{h}x{c}: max|diff| {err}, "
                  f"{(y != r).sum().item()} of {y.numel()} differ (tolerance: bit-exact); "
                  f"{(r.abs() == 127).float().mean().item():.4f} of the outputs saturate; "
                  f"plan {tuple(plan)}, shared memory {stats.smem} B (Python = C)", flush=True)
            if not torch.equal(y, r):
                raise AssertionError(f"K3 is not bit-exact to its plain version at "
                                     f"B={b} {h}x{h}x{c}")
            del xq, pack, y, r

    # 6. the main path
    spec = yolov3_spec(num_classes=2)
    params = params_from_jax(random_jax_params(spec, SEED), spec)
    det = Detector(spec, params, conf_thres=0.3)
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, 256, (DETECTOR_BATCHES[0], 1536, 1536, 3)).astype(np.uint8)
               for _ in range(3)]
    drive(det, batches, {"resize_normalize": 3, "fused_residual_block": 69,
                         "fused_residual_block_int8": 0})
    counts = launch_counts()

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

    # 7. the int8 Detectors
    int8_dets = {}
    for precision in ("int8_full", "int8_early"):
        d8 = Detector(spec, params, conf_thres=0.3, precision=precision)
        t0 = time.perf_counter()
        d8.calibrate(batches[0])
        torch.cuda.synchronize()
        print(f"{precision} calibration on 8 tiles: {time.perf_counter() - t0:.2f} s")
        drive(d8, batches, {"resize_normalize": 3, "fused_residual_block": 0,
                            "fused_residual_block_int8": 0})
        int8_dets[precision] = d8
    drive(Detector(spec, params, conf_thres=0.3, fold_bn=False), batches[:1],
          {"resize_normalize": 1, "fused_residual_block": 0, "fused_residual_block_int8": 0})
    full = int8_dets["int8_full"]
    with tempfile.TemporaryDirectory() as tmp:
        sidecar = full.save_calibration(os.path.join(tmp, "int8_full.json"))
        cpu = Detector(spec, params, conf_thres=0.3, precision="int8_full", device="cpu")
        cpu.load_calibration(sidecar)
    with torch.inference_mode():
        one = torch.from_numpy(batches[1][:1])
        card_maps = full.head_maps(one.to(dev))
        cpu_maps = cpu.head_maps(one)
    for m, p in zip(card_maps, cpu_maps):
        rel = ((m.cpu() - p).abs().max() / p.abs().max()).item()
        print(f"int8_full head {tuple(m.shape)}: max|card-cpu| / max|cpu| = {rel} "
              f"(tolerance {HEAD_TOL}); max|cpu| {p.abs().max().item()}", flush=True)
        if not (torch.isfinite(m).all() and rel <= HEAD_TOL):
            raise AssertionError("int8_full head maps on the card disagree with the CPU")

    # 8. K3's path: the calibrated model's 23 units, chained stage by stage
    units = pack_model_int8_units(full._qparams, full._act_scales, spec, dev)
    if len(units) != 23:
        raise AssertionError(f"{len(units)} int8 units, want 23")

    def stage_input(b, i):
        h = 416 // (2 ** sum(1 for j in range(i) if getattr(spec.layers[j], "stride", 1) == 2))
        c = spec.layers[i].in_ch
        # leaky activations: mostly small, positive, with a negative tail
        z = 24 * torch.randn(b, h, h, c, device=dev, generator=gen)
        return torch.clamp(torch.round(torch.where(z >= 0, z, 0.1 * z)), -127, 127).to(torch.int8)

    def chain(b, fn):
        x, outs = None, []
        for i, u in units.items():
            if x is None or (i - 3) not in units:
                x = stage_input(b, i)
            y = fn(x, *u.pack, sx=u.sx, s1=u.s1, s_out=u.s_out)
            outs.append((i, x, y))
            x = y
        return outs

    def check_chain(b, outs):
        nonlocal k3_err
        n_diff = n_sat = n_all = 0
        for i, x, y in outs:
            u = units[i]
            r = fused_residual_block_int8_plain(x, *u.pack, sx=u.sx, s1=u.s1, s_out=u.s_out)
            n_diff += (y != r).sum().item()
            n_sat += (r.abs() == 127).sum().item()
            n_all += r.numel()
            k3_err = max(k3_err, (y.int() - r.int()).abs().max().item())
        print(f"K3 on the model's 23 units (B={b}): {n_diff} of {n_all} values differ from "
              f"the plain version (tolerance: bit-exact); {n_sat / n_all:.4f} of the outputs "
              "saturate", flush=True)
        if n_diff:
            raise AssertionError(f"K3 is not bit-exact on the model's units at B={b}")

    reset_launch_counts()
    outs8 = chain(8, fused_residual_block_int8)
    torch.cuda.synchronize()
    k3_launches = launch_counts()["fused_residual_block_int8"]
    print(f"K3 path (23 units of the int8_full model, B=8): {launch_counts()}")
    if k3_launches != 23:
        raise AssertionError(f"K3 path launched K3 {k3_launches} times, want 23")
    check_chain(8, outs8)
    del outs8
    check_chain(4, chain(4, fused_residual_block_int8))

    # 9. timings
    detector = {}
    with torch.inference_mode():
        for name, d in (("bf16", det), *int8_dets.items()):
            for b in DETECTOR_BATCHES:
                ms = detector_ms(d, b, dev, gen)
                detector[f"{name}_b{b}"] = {"ms_per_batch": ms, "tiles_per_s": b / ms * 1e3}
                print(f"Detector {name} B={b} (tiles on the card): {ms:.3f} ms/batch, "
                      f"{b / ms * 1e3:.1f} tiles/s [{card}]", flush=True)

        tiles8 = torch.randint(0, 256, (8, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                               generator=gen)
        for name, d in (("bf16", det), ("int8_full", full)):
            detector[f"{name}_b8"].update(profile_detector(d, tiles8))
            print(f"Detector {name} B=8 device time by kernel: "
                  f"{json.dumps(detector[f'{name}_b8'])} [{card}]", flush=True)
        k1_ms = cuda_ms(lambda: resize_normalize(tiles8, 416))
        k1_plain_ms = cuda_ms(lambda: resize_normalize_plain(tiles8, 416))
        k1_bound = 8 * (416 * 1536 * 3 + 416 * 416 * 3 * 2) / PEAK_BYTES * 1e3
        print(f"K1 B=8: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
              f"bound {k1_bound:.4f} ms (bytes) [{card}]")

        k2_rows = {}
        for b in DETECTOR_BATCHES:
            k2_rows[b] = []
            for h, c, n in STAGES:
                plan, stats, c_bps = checked_plan(b, h, c, K2)
                x, w1t, b1, w2t, b2 = k2_stage_inputs(b, h, c, dev, gen)
                ms = cuda_ms(lambda: fused_residual_block(x, w1t, b1, w2t, b2))
                plain_ms = (cuda_ms(lambda: fused_residual_block_plain(x, w1t, b1, w2t, b2))
                            if b == 8 else None)
                xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
                w1c = w1t[:, :, None, None].contiguous(memory_format=torch.channels_last)
                w2c = w2t.reshape(3, 3, c, c // 2).permute(2, 3, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                hc = torch.randn(b, c // 2, h, h, device=dev, generator=gen).to(
                    torch.bfloat16).contiguous(memory_format=torch.channels_last)
                lib_ms = (cuda_ms(lambda: F.conv2d(xc, w1c))
                          + cuda_ms(lambda: F.conv2d(hc, w2c, padding=1)))
                bound, by = k2_bound(b, h, c)
                tflops = b * unit_flops(h, h, c) / ms / 1e9
                k2_rows[b].append({
                    "shape": f"{b}x{h}x{h}x{c}", "units": n, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                    "plan": list(plan), "grid": stats.grid, "blocks_per_sm": c_bps,
                    "waves": stats.grid / (sms * c_bps), "work_ratio": stats.work_ratio,
                    "tflops": tflops})
                plain = f"{plain_ms:.4f} ms" if plain_ms is not None else "not measured"
                print(f"K2 B={b} {h}x{h}x{c}: grid {stats.grid}, {c_bps} blocks/SM, "
                      f"{stats.grid / (sms * c_bps):.2f} waves, executed-work ratio "
                      f"{stats.work_ratio:.3f}, {tflops:.1f} TFLOP/s; kernel {ms:.4f} ms, "
                      f"plain {plain}, cuDNN 1x1+3x3 {lib_ms:.4f} ms, bound {bound:.4f} ms "
                      f"({by}) [{card}]", flush=True)
                del x, xc, hc
        stages = k2_rows[8]
        print(f"K2 23 units: B=8 {sum(s['ms'] * s['units'] for s in stages):.4f} ms, "
              f"B=32 {sum(s['ms'] * s['units'] for s in k2_rows[32]):.4f} ms [{card}]")

        k3_rows = {}
        for b in DETECTOR_BATCHES:
            k3_rows[b] = []
            for h, c, n in STAGES:
                plan, stats, c_bps = checked_plan(b, h, c, K3)
                xq, pack = k3_stage_inputs(b, h, c, dev, gen)
                ms = cuda_ms(lambda: fused_residual_block_int8(xq, *pack, sx=sx, s1=s1,
                                                               s_out=s_out))
                plain_ms = (cuda_ms(lambda: fused_residual_block_int8_plain(
                    xq, *pack, sx=sx, s1=s1, s_out=s_out)) if b == 8 else None)
                # yardstick: the two GEMMs alone, epilogues left out — the 1x1
                # on the map, the 3x3 as one GEMM on a prebuilt im2col matrix
                a1x1 = xq.reshape(-1, c)
                w1 = pack[0].t()
                hq = torch.randint(-127, 128, (b, h + 2, h + 2, c // 2), dtype=torch.int8,
                                   device=dev, generator=gen)
                cols = torch.cat([hq[:, di:di + h, dj:dj + h].reshape(-1, c // 2)
                                  for di in range(3) for dj in range(3)], dim=1)
                del hq
                w2 = pack[3].permute(1, 0, 2).reshape(c, 9 * (c // 2)).t()
                lib_ms = (cuda_ms(lambda: torch._int_mm(a1x1, w1))
                          + cuda_ms(lambda: torch._int_mm(cols, w2)))
                bound, by = k3_bound(b, h, c)
                tops = b * unit_flops(h, h, c) / ms / 1e9
                k3_rows[b].append({
                    "shape": f"{b}x{h}x{h}x{c}", "units": n, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                    "plan": list(plan), "grid": stats.grid, "blocks_per_sm": c_bps,
                    "waves": stats.grid / (sms * c_bps), "work_ratio": stats.work_ratio,
                    "tops": tops})
                plain = f"{plain_ms:.4f} ms" if plain_ms is not None else "not measured"
                print(f"K3 B={b} {h}x{h}x{c}: grid {stats.grid}, {c_bps} blocks/SM, "
                      f"{stats.grid / (sms * c_bps):.2f} waves, executed-work ratio "
                      f"{stats.work_ratio:.3f}, {tops:.1f} TOP/s; kernel {ms:.4f} ms, "
                      f"plain {plain}, _int_mm 1x1 + im2col 3x3 (GEMMs only) {lib_ms:.4f} ms, "
                      f"bound {bound:.4f} ms ({by}) [{card}]", flush=True)
                del xq, pack, cols
        stages3 = k3_rows[8]
        print(f"K3 23 units: B=8 {sum(s['ms'] * s['units'] for s in stages3):.4f} ms, "
              f"B=32 {sum(s['ms'] * s['units'] for s in k3_rows[32]):.4f} ms [{card}]")

    # 10. the folder path
    folder = folder_phase(det, spec, params, card)

    def total(rows, key):
        return sum(s[key] * s["units"] for s in rows)

    def bound_by(rows):
        ops = sum(s["bound_ms"] * s["units"] for s in rows if s["bound_by"] == "operations")
        return "operations" if ops >= total(rows, "bound_ms") / 2 else "bytes"

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
         "ms": total(stages, "ms"), "kernel_ms": total(stages, "ms"),
         "plain_ms": total(stages, "plain_ms"), "bound_ms": total(stages, "bound_ms"),
         "bound_by": bound_by(stages), "library_ms": total(stages, "library_ms"),
         "shape": "the 23 units of one B=8 batch", "stages": stages,
         "stages_b32": k2_rows[32]},
        {"name": "fused_residual_block_int8", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/int8_block.cu",
         "replaces": "amyloid_yolo_tpu/pallas/int8_block.py:150",
         "launches": k3_launches, "max_abs_err": k3_err,
         "max_abs_diff": k3_err, "tol": "bit-exact",
         "ms": total(stages3, "ms"), "kernel_ms": total(stages3, "ms"),
         "plain_ms": total(stages3, "plain_ms"), "bound_ms": total(stages3, "bound_ms"),
         "bound_by": bound_by(stages3), "library_ms": total(stages3, "library_ms"),
         "shape": "the 23 units of one B=8 batch", "stages": stages3,
         "stages_b32": k3_rows[32]},
    ]
    print(json.dumps({"detector": detector, "card": card}))
    print(json.dumps({"folder": folder, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
