"""Load benchmark for the port's HTTP detection service
(``python -m amyloid_yolo_tpu_torch.cli serve``), ``tools/serve_bench.py``'s
counterpart on one NVIDIA GPU.

Starts a :class:`~amyloid_yolo_tpu_torch.serving.DetectionServer`
IN-PROCESS plus ``--concurrency`` client threads that POST one payload in
a closed loop for ``--duration`` seconds per phase, then prints one JSON
line per phase, with the reference tool's keys and ``device``, the card
the server runs on (``cpu`` with ``--device cpu``, where every time is
the CPU's):

    {"mode": "jpeg", "req_per_s": ..., "p50_ms": ..., "p90_ms": ...,
     "p99_ms": ..., "batched_ratio": ..., "errors": 0, ..., "device": ...}

``--img_side`` accepts a comma list and ``--ab True`` runs a jpeg AND a
raw-pixel phase per side — every phase drives the SAME warm server.
``--raw True`` alone posts raw uint8 RGB (``X-Image-Shape`` header): the
co-located-tiler operating point, no JPEG round-trip.  ``--fast_path``
mirrors the CLI's (``cli/main.py:_fast_path_kwargs``): the reference's
approximate top-k has no counterpart, the port selects the pool exactly.
``--model_def`` builds the graph from a darknet cfg (default: the native
2-class YOLOv3).

Two operating points:

* ``--img_side 1536`` (default): the production tile size.  Each request
  pays a full 1536^2 JPEG decode on the host, so the service is bound by
  the host's decode, not by the device; ``batched_ratio`` stays near 1 at
  low concurrency because decode serializes arrivals.
* ``--img_side 416``: pre-resized clients (an upstream tiler that already
  emits model-sized tiles): decode is much cheaper and micro-batching
  engages (``batched_ratio`` > 1).

Usage::

    python tools/serve_bench_torch.py --precision int8_full --fast_path True \
        --concurrency 32 --duration 30
    python tools/serve_bench_torch.py --img_side 416 --concurrency 64

Overload (bounded memory and p99 at several times saturation): raise
``--concurrency`` well past what the host sustains and shrink
``--max_queue``; ``shed``, ``queue_depth_max`` and ``rss_mb_peak`` show the
bound holding while 200s keep flowing::

    python tools/serve_bench_torch.py --img_side 416 --concurrency 128 \
        --max_queue 32 --duration 30
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _truthy(v) -> bool:
    return str(v) in ("True", "true", "1")


def make_jpeg(side: int, quality: int = 90) -> bytes:
    """One representative tile: smooth background + hard blobs, so the
    JPEG is realistically sized (pure noise over-weights Huffman cost)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:side, 0:side]
    img = (128 + 40 * np.sin(yy / 97.0) + 40 * np.cos(xx / 61.0))
    img = np.stack([img, img * 0.9, img * 0.8], -1)
    for _ in range(24):
        cy, cx = rng.randint(0, side, 2)
        r = rng.randint(side // 64 + 2, side // 16 + 4)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[m] = rng.randint(0, 255, 3)
    buf = io.BytesIO()
    Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def run_client(host: str, port: int, body: bytes, deadline: float,
               lat_ms: list, errors: list, shed: list,
               raw_shape: "tuple | None" = None):
    headers = {"Content-Type": "application/octet-stream"}
    if raw_shape is not None:
        headers["X-Image-Shape"] = f"{raw_shape[0]},{raw_shape[1]}"
    conn = http.client.HTTPConnection(host, port, timeout=300)
    while time.monotonic() < deadline:
        t0 = time.monotonic()
        try:
            conn.request("POST", "/v1/detect", body=body, headers=headers)
            resp = conn.getresponse()
            resp.read()
            if resp.status == 503:  # load shed: bounded queue said not now
                shed.append((time.monotonic() - t0) * 1e3)
                continue
            if resp.status != 200:
                errors.append(resp.status)
                continue
        except Exception as e:  # connection reset at shutdown etc.
            errors.append(type(e).__name__)
            conn = http.client.HTTPConnection(host, port, timeout=300)
            continue
        lat_ms.append((time.monotonic() - t0) * 1e3)
    conn.close()


def rss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", type=str, default="int8_full",
                    choices=["bf16", "int8_early", "int8_full"])
    ap.add_argument("--fast_path", type=str, default="True")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--img_side", type=str, default="1536",
                    help="tile side, or a comma list (e.g. 1536,416) — each "
                         "side runs as its own measured phase against the "
                         "same warm server (one compile, one process)")
    ap.add_argument("--host_resize", type=str, default="True",
                    help="server-side nearest resize before the upload "
                         "(uploads 416^2 instead of 1536^2)")
    ap.add_argument("--img", type=str, default=None,
                    help="POST this image file instead of the synthetic tile")
    ap.add_argument("--native_decode", type=str, default="True",
                    help="C++ in-memory decode for exact-tile JPEGs")
    ap.add_argument("--fast_decode", type=str, default="False",
                    help="DCT-scaled native decode (non-parity pixels)")
    ap.add_argument("--max_queue", type=int, default=None,
                    help="bounded executor queue (default 8x batch)")
    ap.add_argument("--raw", type=str, default="False",
                    help="POST raw uint8 RGB pixels (X-Image-Shape header) "
                         "instead of JPEG — the co-located-tiler operating "
                         "point; skips the host Huffman decode entirely")
    ap.add_argument("--ab", type=str, default="False",
                    help="run BOTH a jpeg and a raw phase per img_side "
                         "(same warm server) — the clean in-process A/B")
    ap.add_argument("--model_def", type=str, default=None,
                    help="darknet cfg to build the graph from (default: the "
                         "native 2-class YOLOv3)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the server's device; without a card only 'cpu' runs")
    args = ap.parse_args(argv)

    import torch

    from amyloid_yolo_tpu_torch.cli.main import _fast_path_kwargs
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import from_cfg, yolov3_spec
    from amyloid_yolo_tpu_torch.serving import DetectionServer

    fast = _truthy(args.fast_path)
    kw = _fast_path_kwargs(argparse.Namespace(
        fast_path=fast, precision=args.precision if fast else None, calib_percentile=None))
    spec = from_cfg(args.model_def) if args.model_def else yolov3_spec(num_classes=2)
    det = Detector(
        spec, None, conf_thres=0.5, nms_thres=0.4,
        host_resize=_truthy(args.host_resize), device=args.device, **kw)
    device = (torch.cuda.get_device_name(det.device) if det.device.type == "cuda"
              else det.device.type)
    server = DetectionServer(det, host="127.0.0.1", port=0,
                             batch_size=args.batch_size,
                             max_wait_ms=args.max_wait_ms,
                             native_decode=_truthy(args.native_decode),
                             fast_decode=_truthy(args.fast_decode),
                             max_queue=args.max_queue)
    server.start()
    from PIL import Image

    sides = [int(s) for s in str(args.img_side).split(",")]
    if args.img:
        # one real file = one payload: a multi-side sweep would post the
        # SAME bytes under different img_side labels, so the one reported
        # side comes from the decoded image
        if len(sides) > 1:
            raise SystemExit("--img is a single payload; it cannot be "
                             "combined with a comma --img_side sweep")
        data = open(args.img, "rb").read()
        real = Image.open(io.BytesIO(data)).size[0]
        sides = [real]
        jpegs = {real: data}
    else:
        jpegs = {s: make_jpeg(s) for s in sides}
    # calibrate on the actual traffic tile (int8), compile before timing
    calib = np.asarray(Image.open(io.BytesIO(jpegs[sides[0]])).convert("RGB"))
    if calib.shape[0] != det.tile_size:
        from amyloid_yolo_tpu_torch.ops.preprocess import nearest_indices

        idx = nearest_indices(det.tile_size, calib.shape[0])
        calib = np.ascontiguousarray(calib[idx][:, idx])
    server.warmup(np.broadcast_to(calib, (args.batch_size,) + calib.shape))

    if _truthy(args.ab):
        modes = ["jpeg", "raw"]
    elif _truthy(args.raw):
        # co-located-tiler operating point: the client already holds
        # pixels, so POST them raw (X-Image-Shape) — no JPEG round-trip
        modes = ["raw"]
    else:
        modes = ["jpeg"]

    rss_before = rss_mb()
    rc = 0
    for side in sides:
        for mode in modes:
            if mode == "raw":
                arr = np.asarray(
                    Image.open(io.BytesIO(jpegs[side])).convert("RGB"))
                raw_shape = (arr.shape[0], arr.shape[1])
                body = arr.tobytes()
            else:
                raw_shape = None
                body = jpegs[side]
            print(f"driving {args.concurrency} clients for "
                  f"{args.duration:.0f}s ({len(body)/1e3:.0f} kB {mode}, "
                  f"side {side})", file=sys.stderr, flush=True)

            lat_ms: list = []
            errors: list = []
            shed: list = []
            stats0 = server._stats()
            deadline = time.monotonic() + args.duration
            threads = [threading.Thread(
                target=run_client,
                args=("127.0.0.1", server.port, body, deadline, lat_ms,
                      errors, shed, raw_shape),
                daemon=True) for _ in range(args.concurrency)]
            # sample the live queue depth so the overload report shows the
            # bound held
            depth_max = [0]
            mon_stop = threading.Event()

            def monitor():
                while not mon_stop.is_set():
                    depth_max[0] = max(depth_max[0],
                                       server.executor.queue_depth())
                    time.sleep(0.02)

            mon = threading.Thread(target=monitor, daemon=True)
            mon.start()
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=args.duration + 300)
            wall = time.monotonic() - t0
            mon_stop.set()
            mon.join(5)
            stats = server._stats()

            lat = np.sort(np.asarray(lat_ms)) if lat_ms else np.asarray([0.0])
            d_req = stats["requests"] - stats0["requests"]
            d_disp = stats["dispatches"] - stats0["dispatches"]
            out = {
                "mode": mode,
                "req_per_s": round(len(lat_ms) / wall, 2),
                "n_ok": len(lat_ms),
                "errors": len(errors),
                "p50_ms": round(float(np.percentile(lat, 50)), 1),
                "p90_ms": round(float(np.percentile(lat, 90)), 1),
                "p99_ms": round(float(np.percentile(lat, 99)), 1),
                # per-phase counters (diffed — the server stays up across
                # phases so the raw /stats totals span all of them)
                "batched_ratio": round(d_req / max(d_disp, 1), 3),
                "dispatches": d_disp,
                "native_decodes": (stats["native_decodes"]
                                   - stats0["native_decodes"]),
                "raw_requests": stats["raw_requests"] - stats0["raw_requests"],
                "concurrency": args.concurrency,
                "img_side": side,
                "precision": det.precision,
                "batch_size": args.batch_size,
                # overload/backpressure observables: shed count (503s), how
                # fast a shed answer returns, the max live queue depth (must
                # stay <= max_queue), and process peak RSS growth over the
                # run (bounded memory under any offered load)
                "shed": stats["shed"] - stats0["shed"],
                "shed_p50_ms": round(float(
                    np.percentile(np.asarray(shed), 50)), 1) if shed else None,
                "queue_depth_max": depth_max[0],
                "max_queue": stats["max_queue"],
                "rss_mb_start": round(rss_before, 1),
                "rss_mb_peak": round(rss_mb(), 1),
                "device": device,
            }
            if errors:
                rc = 1
            print(json.dumps(out), flush=True)
    server.stop()
    return rc


if __name__ == "__main__":
    sys.exit(main())
