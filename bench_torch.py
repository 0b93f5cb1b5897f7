"""Benchmark of the PyTorch/CUDA port: 1536px WSI tiles/s on one NVIDIA GPU
at batch 32 (the port's counterpart of ``bench.py``).

Measures the port's Detector pipeline on tiles already on the card:

    uint8 1536² tiles (on the card)
      → K1: nearest 1536→416 + /255 (``csrc/resize_normalize.cu``)
      → Darknet-53/YOLOv3 (``int8_full``: int8 convs with the RGB stem and
        the head convs in bf16, by default; K2 fused residual units in bf16)
      → lazy score→top-k→sparse anchor decode
      → class-aware merging NMS → tile-space boxes

Methodology, as ``bench.py``'s:

* **Headline (stdout JSON, last line)**: tiles/s of
  ``Detector(precision=BENCH_PRECISION, int8_downsample=BENCH_INT8_DS,
  lazy_decode=BENCH_LAZY, s2d_stem=BENCH_S2D, int32_accum_max_hw=
  BENCH_I32DEEP_HW)`` calibrated on the first two tiles, on random uint8
  tiles (``np.random.RandomState(0)``): one call, then ``reps`` repetitions
  of 3 warm-up calls and ``BENCH_ITERS`` timed calls between CUDA events;
  the best repetition counts, and each one's time is printed on stderr.
  ``BENCH_APPROX`` (the reference's approximate top-k) has no counterpart:
  the port selects the NMS pool exactly, and says so on stderr.
* **Second line (stdout JSON, first)**: the bf16 parity pipeline,
  ``Detector()``, one repetition.
* **Diagnostics (stderr, ``#`` lines)**: the card's name and power limit
  (``nvidia-smi``), the torch and CUDA versions; each pipeline's kernel
  launches per call; the host-resized (416² input) variant; host-fed
  streaming from pageable host memory over PCIe; the MFU of each line
  (``tools/mfu_torch.py``: conv FLOPs over the H100's bf16 and int8 peaks).

``vs_baseline`` compares against ``bench.py``'s estimated reference
throughput of 30 tiles/s (PyTorch YOLOv3-416 on the reference's GTX 1080 at
batch 8, derated for its host-side NMS and preprocess).

Without a CUDA card ``main()`` raises: the bench measures the card.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "tools")) if p not in sys.path]

BASELINE_TILES_PER_SEC = 30.0
#: the environment and its defaults, as ``bench.py`` reads them
DEFAULTS = {"BENCH_BATCH": "32", "BENCH_ITERS": "30", "BENCH_PRECISION": "int8_full",
            "BENCH_INT8_DS": "32", "BENCH_LAZY": "1", "BENCH_APPROX": "1", "BENCH_S2D": "1",
            "BENCH_I32DEEP_HW": "0"}


def config(env=None) -> dict:
    """The bench's settings from ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env

    def get(k):
        return env.get(k, DEFAULTS[k])

    return {"batch": int(get("BENCH_BATCH")), "iters": int(get("BENCH_ITERS")),
            "precision": get("BENCH_PRECISION"), "int8_ds": int(get("BENCH_INT8_DS")),
            "lazy": get("BENCH_LAZY") == "1", "approx": get("BENCH_APPROX") == "1",
            "s2d": get("BENCH_S2D") == "1", "i32_hw": int(get("BENCH_I32DEEP_HW"))}


def detector_kwargs(cfg: dict) -> dict:
    """The headline Detector's options: ``bench.py``'s, less ``approx_topk``."""
    precision = cfg["precision"]
    return dict(precision=precision, int8_downsample=cfg["int8_ds"], lazy_decode=cfg["lazy"],
                s2d_stem=cfg["s2d"] and precision != "int8_early",
                int32_accum_max_hw=cfg["i32_hw"])


def metric_line(batch: int, tiles_per_s: float, suffix: str = "") -> str:
    """One stdout line in ``bench.py``'s shape and rounding."""
    return json.dumps({
        "metric": f"wsi_tiles_per_sec_per_chip_1536px_b{batch}{suffix}",
        "value": round(tiles_per_s, 2),
        "unit": "tiles/s",
        "vs_baseline": round(tiles_per_s / BASELINE_TILES_PER_SEC, 2),
    })


def measure(det, inp, iters=40, reps=2, label=None):
    """Best seconds per call of ``det(inp)`` over ``reps`` repetitions of 3
    warm-up calls and ``iters`` calls between CUDA events (one call
    before, as ``bench.py:measure``); ``label`` prints each repetition."""
    import torch

    det(inp)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        for _ in range(3):
            det(inp)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            det(inp)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / 1e3 / iters)
    if label:
        print(f"# {label}: {', '.join(f'{t * 1e3:.3f}' for t in times)} ms/batch over "
              f"{reps} reps of {iters} calls (best {min(times) * 1e3:.3f})", file=sys.stderr)
    return min(times)


def counted(det, inp, iters, reps, label):
    """:func:`measure` with the kernels' launches per call printed beside."""
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t = measure(det, inp, iters, reps, label)
    calls = 1 + reps * (3 + iters)
    per_call = {k: v / calls for k, v in launch_counts().items()}
    print(f"# launches per call ({label}): {json.dumps(per_call)}", file=sys.stderr)
    return t


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def print_card(device) -> None:
    """The ``# card: <name>, <power limit>`` line on stderr that the
    measurement tools print before their numbers (``# card: cpu`` on the
    CPU, where no number is a device number)."""
    from amyloid_yolo_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    print(f"# card: {card_line() if dev.type == 'cuda' else 'cpu'}", file=sys.stderr, flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py measures the card, and CUDA is not available: "
                           "no number it prints may come from the CPU")

    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
    from amyloid_yolo_tpu_torch.ops.preprocess import nearest_indices
    from mfu_torch import H100_BF16_TFLOPS, H100_INT8_TOPS, conv_gflops

    cfg = config()
    batch, iters, precision = cfg["batch"], cfg["iters"], cfg["precision"]
    print(f"# card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    if cfg["approx"]:
        print("# BENCH_APPROX=1 left out: the port has no approximate top-k and selects "
              "the NMS candidate pool exactly", file=sys.stderr)

    rng = np.random.RandomState(0)
    tiles = rng.randint(0, 255, (batch, 1536, 1536, 3)).astype(np.uint8)
    idx = nearest_indices(416, 1536)
    small = np.ascontiguousarray(tiles[:, idx][:, :, idx])
    gflop = conv_gflops(yolov3_spec(num_classes=2), 416)

    def mfu(t):
        tflops = gflop * batch / t / 1e3
        return (f"{tflops:.1f} TFLOP/s = {tflops / H100_BF16_TFLOPS * 100:.2f}% of the H100 "
                f"bf16 peak ({H100_BF16_TFLOPS:g}), {tflops / H100_INT8_TOPS * 100:.2f}% of "
                f"its int8 peak ({H100_INT8_TOPS:g})")

    # headline: the full pipeline on the card, 1536² input already there
    det = Detector(**detector_kwargs(cfg))
    if precision != "bf16":
        det.calibrate(tiles[:2])
    dev_tiles = torch.from_numpy(tiles).to(det.device)
    t_head = counted(det, dev_tiles, iters, 2, f"headline {precision}")
    chip_tps = batch / t_head

    # second metric: the box-for-box parity pipeline, printed before the
    # headline so that the headline stays the last line
    det_bf16 = Detector()
    t_bf16 = counted(det_bf16, dev_tiles, iters, 1, "bf16 parity")
    parity_tps = batch / t_bf16
    print(f"# bf16 parity pipeline (device-resize): {parity_tps:.0f} tiles/s; MFU "
          f"{mfu(t_bf16)} (against bf16: its convs are bf16)", file=sys.stderr)
    print(metric_line(batch, parity_tps, "_bf16_parity"), flush=True)
    del det_bf16

    det_hr = Detector(host_resize=True, **detector_kwargs(cfg))
    if precision != "bf16":
        det_hr.calibrate(small)
    t_hr = counted(det_hr, torch.from_numpy(small).to(det_hr.device), iters, 1,
                   "host-resized 416² input")
    print(f"# host-resized 416² input variant: {batch / t_hr:.0f} tiles/s", file=sys.stderr)

    n_stream = max(4, iters // 6)
    bufs = [np.ascontiguousarray(small + i) for i in range(2)]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n_stream):
        det_hr(bufs[i % 2])
    stop.record()
    torch.cuda.synchronize()
    stream_tps = batch * n_stream / (start.elapsed_time(stop) / 1e3)
    print(f"# host-fed streaming ({n_stream} calls from two pageable host buffers, 416² "
          f"uint8, uploaded over PCIe): {stream_tps:.1f} tiles/s", file=sys.stderr)
    print(f"# headline {precision}: {chip_tps:.1f} tiles/s; MFU {mfu(t_head)} (its stem and "
          "head convs run in bf16, the rest in int8)" if precision != "bf16" else
          f"# headline bf16: {chip_tps:.1f} tiles/s; MFU {mfu(t_head)}", file=sys.stderr)
    print(metric_line(batch, chip_tps), flush=True)


if __name__ == "__main__":
    main()
