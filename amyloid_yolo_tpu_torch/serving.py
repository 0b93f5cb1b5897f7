"""HTTP detection service with micro-batching, on the GPU.

Counterpart of the reference package's ``serving.py``: the same endpoints,
status codes, JSON shapes, bounds and counters.  The per-request semantics
are those of the detect path: square-pad into the tile frame, the
:class:`~amyloid_yolo_tpu_torch.detectors.Detector` (K1 and K2 on the card
for the bf16 precision), the rescale back to the image's own pixels
(``detect.py:129`` of the original), and optionally the union merge and the
CAA filter (``core.py:366-423``, ``core.py:173-231``).

* **One batch shape.**  A :class:`BatchingExecutor` gathers requests and
  pads every dispatch to ``batch_size`` by repeating the last tile (the
  ``ImageFolder._pack`` convention), so the kernels see the same shapes on
  every dispatch.
* **Micro-batching.**  Requests arriving within ``max_wait_ms`` of each
  other ride the same dispatch; a lone request waits about
  ``max_wait_ms``.  The executor thread is the only thread that launches
  the Detector's kernels, so the host decode (request threads) and the
  device overlap.  It dispatches under :func:`torch.inference_mode`
  itself: autograd's grad mode is thread-local, and a mode set in the
  thread that started the server does not reach it.
* **No web framework.**  ``http.server.ThreadingHTTPServer`` and PIL.
* **Native decode.**  Exact-tile JPEG bodies decode through the port's
  tile reader (``io/native.py:decode_tile_bytes``, bit-identical to PIL,
  the GIL released) where it is built; anything else (PNG, border tiles,
  corrupt bodies, or no reader) takes the PIL and ``pad_to_square`` path
  with the same result.  ``fast_decode=True`` opts a ``host_resize``
  server into the DCT-scaled decode (not bit-identical, as
  ``ImageFolder(fast_decode)``).

Endpoints:

* ``POST /v1/detect``: the body is an encoded image (JPEG, PNG, ...), or
  raw uint8 RGB pixels (C order) with an ``X-Image-Shape: H,W`` header (the
  header alone selects the raw path; ``Content-Type`` is not read).  The
  raw form lets a tiler that holds pixels skip the JPEG round trip, whose
  host decode bounds the JPEG path.  Query parameters: ``merge`` (union
  merge, default 1), ``caa_filter`` (the CAA filter when the server has
  one, default 1).  Answer: ``{"detections": [{"x1", "y1", "x2", "y2",
  "conf", "cls_conf", "cls", "label"}], "image_hw": [H, W]}`` in the
  image's own pixels.
* ``GET /healthz``: liveness and the torch device: ``backend`` (``cuda``
  or ``cpu``), ``devices`` (CUDA devices visible), ``device_name`` (the
  card's name, or ``cpu``) and ``warmed_up``.  The reference reports JAX's
  backend and ``compiled``; PyTorch runs eagerly and compiles no program,
  so ``warmed_up`` says whether a dispatch has completed (the kernels are
  built and loaded then).
* ``GET /stats``: the reference's counters: requests, dispatches,
  ``batched_ratio`` (> 1 means micro-batching works), ``queue_depth``,
  ``shed``, ``rejected_oversize``, ``nms_pool_overflows`` and the rest.

Bounds:

* **Bounded queue and load shedding**: at most ``max_queue`` requests
  (default 8 × batch) wait; past that a request is answered ``503`` with
  ``Retry-After`` at once (before its body is read when the queue is
  already full).
* **Payload cap**: a ``Content-Length`` over ``max_body_bytes`` (default
  32 MB) is answered ``413`` before anything is read.
* **Side cap**: an image side over ``max_side`` (default the tile size) is
  ``413`` on a raw header and ``400`` on a decoded image.
* **Per-request timeout**: ``request_timeout_s`` bounds a request's stay in
  the queue and on the device (``503``); a request that times out while
  still queued is removed and never dispatched.

Usage::

    python -m amyloid_yolo_tpu_torch.cli serve --weights_path ckpt.pth --port 8498

or in code::

    server = DetectionServer(Detector(...), class_names=["CAA", "Cored"])
    server.start()            # returns at once; .port is bound
    ...
    server.stop()
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .detectors import Detector
from .io import native as _native
from .io.datasets import pad_to_square_np
from .ops.boxes import rescale_from_tile_frame
from .ops.merge import merge_detections
from .ops.preprocess import nearest_indices


class _HTTPServer(ThreadingHTTPServer):
    """The reference's ``ThreadingHTTPServer`` with a listen backlog of
    128: at socketserver's default of 5, the connections of a burst past
    5 wait for the kernel's SYN retries (1 s and more) and reach the
    early shed late, while their clients already send bodies."""

    daemon_threads = True
    request_queue_size = 128


class QueueFullError(RuntimeError):
    """The executor's bounded queue is at capacity — the request was SHED,
    not enqueued (the caller should answer 503 + Retry-After)."""


class _Pending:
    """One in-flight request: a tile plus an Event the executor sets."""

    __slots__ = ("tile", "event", "result", "error")

    def __init__(self, tile: np.ndarray):
        self.tile = tile
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class BatchingExecutor:
    """Gathers concurrent requests into fixed-shape device batches.

    The device sees one static batch shape forever: fewer than
    ``batch_size`` pending requests are padded by repeating the last tile
    (the ``ImageFolder._pack`` convention), extra requests wait for the
    next dispatch.  ``max_wait_ms`` bounds the time a lone request waits
    for company.

    **Backpressure**: the queue is bounded at ``max_queue`` pending
    requests (default ``8 × batch_size``); a ``submit`` past that is shed
    immediately with :class:`QueueFullError` instead of queuing without
    limit — a client burst against a slow device would otherwise grow
    memory and p99 without bound.  Shed requests are counted
    (``n_shed``); ``queue_depth()`` is the live depth.
    """

    def __init__(self, detector: Detector, batch_size: int = 16,
                 max_wait_ms: float = 5.0, max_queue: Optional[int] = None):
        self.detector = detector
        self.batch_size = int(batch_size)
        self.max_wait = max_wait_ms / 1000.0
        self.max_queue = int(max_queue) if max_queue else 8 * self.batch_size
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # stats
        self.n_requests = 0
        self.n_dispatches = 0
        self.n_errors = 0
        self.n_shed = 0

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="amyolo-batcher")
        self._thread.start()
        return self

    def stop(self):
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def record_shed(self) -> None:
        """Count a request shed OUTSIDE :meth:`submit` (the handler's
        early header-shed path).  ``n_shed += 1`` from a request thread
        would race the locked increment in :meth:`submit` and lose
        counts under exactly the overload the counter exists to report."""
        with self._lock:
            self.n_shed += 1

    def submit(self, tile: np.ndarray, timeout: float = 120.0,
               shed: bool = True) -> Optional[np.ndarray]:
        """Block until this tile's detections (ragged (N,7) or None) exist.

        Raises :class:`QueueFullError` (without enqueuing) when the bounded
        queue is full and ``shed=True``; ``shed=False`` bypasses the bound
        (internal warmup, trusted callers)."""
        p = _Pending(tile)
        with self._lock:
            if shed and len(self._queue) >= self.max_queue:
                self.n_shed += 1
                raise QueueFullError(
                    f"queue full ({len(self._queue)}/{self.max_queue} "
                    f"pending); retry later")
            self._queue.append(p)
            self.n_requests += 1
        self._wake.set()
        if not p.event.wait(timeout):
            # drop the request if it is still queued, so a timed-out client
            # doesn't also consume a device slot later (under overload every
            # expired entry dispatched anyway would amplify the backlog)
            with self._lock:
                try:
                    self._queue.remove(p)
                except ValueError:
                    pass  # already dispatched; result is moot
            raise TimeoutError("detection dispatch timed out")
        if p.error is not None:
            raise p.error
        return p.result

    # -- executor thread ----------------------------------------------------

    def _run(self):
        # grad mode is thread-local: this thread sets its own
        with torch.inference_mode():
            self._loop()

    def _loop(self):
        while not self._stop:
            self._wake.wait()
            if self._stop:
                return
            # linger briefly so near-simultaneous requests share a dispatch
            deadline = time.monotonic() + self.max_wait
            while time.monotonic() < deadline:
                with self._lock:
                    if len(self._queue) >= self.batch_size:
                        break
                time.sleep(self.max_wait / 5.0)
            with self._lock:
                batch = self._queue[:self.batch_size]
                del self._queue[:len(batch)]
                if not self._queue:
                    self._wake.clear()
            if not batch:
                continue
            try:
                tiles = [p.tile for p in batch]
                while len(tiles) < self.batch_size:
                    tiles.append(tiles[-1])
                ragged = self.detector.detect_batch_ragged(
                    np.stack(tiles), n_valid=len(batch))
                self.n_dispatches += 1
                for p, det in zip(batch, ragged):
                    p.result = det
                    p.event.set()
            except BaseException as e:  # surface to every waiter, keep serving
                self.n_errors += 1
                for p in batch:
                    p.error = e
                    p.event.set()


class DetectionServer:
    """HTTP detection service around one :class:`Detector`.

    ``merge_boxes`` / ``caa_filter`` set the per-request defaults (query
    params override ``merge``/``caa_filter`` per call).  ``class_names``
    labels the ``cls`` index in responses (reference classes: CAA, Cored).
    """

    def __init__(
        self,
        detector: Detector,
        class_names: Sequence[str] = ("CAA", "Cored"),
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        batch_size: Optional[int] = None,
        max_wait_ms: float = 5.0,
        merge_boxes: bool = True,
        caa_filter=None,
        native_decode: bool = True,
        fast_decode: bool = False,
        max_queue: Optional[int] = None,
        max_body_bytes: int = 32 * 1024 * 1024,
        max_side: Optional[int] = None,
        request_timeout_s: float = 120.0,
    ):
        self.detector = detector
        self.class_names = list(class_names)
        self.merge_boxes = merge_boxes
        self.caa_filter = caa_filter
        # Production bounds: bounded executor queue with
        # load-shedding (503 + Retry-After), a payload ceiling (tiles are
        # ≤ a few MB encoded; a Content-Length past max_body_bytes is
        # rejected 413 before any allocation), and a per-request timeout.
        self.max_body_bytes = int(max_body_bytes)
        # Dimension ceiling: pad_to_square allocates max(H,W)² * 3, so an
        # extreme-aspect image whose BODY is tiny (e.g. 65535x1 raw ≈
        # 197 kB) would otherwise balloon to ~12.9 GB — a one-request OOM
        # past every byte-level bound.  Applied to the
        # raw-RGB header BEFORE the body is read and to PIL-decoded shapes.
        self.max_side = int(max_side) if max_side else detector.tile_size
        self.request_timeout_s = float(request_timeout_s)
        self.n_oversize = 0
        self.executor = BatchingExecutor(
            detector, batch_size or 16, max_wait_ms, max_queue=max_queue)
        self._t0 = time.time()
        self._httpd = _HTTPServer((host, port), self._make_handler())
        self._thread: Optional[threading.Thread] = None
        # resize index for non-tile-sized squares (cached per side)
        self._ridx_cache: Dict[int, np.ndarray] = {}
        # Native decode fast path: exact-tile-sized JPEGs skip PIL and go
        # through the port's C++ reader where it is built (GIL released →
        # request threads decode in parallel); bit-identical to the PIL
        # path (tested).  fast_decode
        # additionally opts into the DCT-scaled decode when host_resize
        # gives a gather target (same opt-in + parity caveat as
        # ImageFolder(fast_decode=True), datasets.py).
        self._native_ok = bool(native_decode) and _native.available()
        self._scale_denom = 1
        if fast_decode and detector.host_resize:
            for d in (8, 4, 2):  # largest scale still >= the gather target
                if (detector.tile_size % d == 0
                        and detector.tile_size // d >= detector.model_size):
                    self._scale_denom = d
                    break
        self._n_native = 0
        self._n_raw = 0
        self._native_lock = threading.Lock()  # guards _n_native/_n_raw AND
        #   n_oversize: both are bumped from concurrent request-handler
        #   threads (ThreadingHTTPServer), where a bare += loses counts
        #   under exactly the flood the counters exist to report

    def record_oversize(self) -> None:
        with self._native_lock:
            self.n_oversize += 1

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self.executor.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="amyolo-http")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.executor.stop()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def warmup(self, calibration_tiles: Optional[np.ndarray] = None) -> bool:
        """Run one dispatch before accepting traffic (optional; the first
        real request does it otherwise): it builds and loads the kernels
        and warms the allocator.  PyTorch compiles no program, so
        "warmed up" takes the place of the reference's "compiled".
        Returns True if the dispatch ran.

        For int8 precisions pass ``calibration_tiles`` (a representative
        uint8 batch) — scales calibrated on them, not on the warmup
        traffic.  Without them warmup is REFUSED for uncalibrated int8:
        the warmup tile would have to be synthetic (noise), and scales
        calibrated on noise silently degrade every real request — noise
        excites every layer, so not even the degenerate-scale check fires.
        In that case the warm-up and calibration defer to the first real
        request (which is representative by definition) and a warning
        recommends ``--calibration_folder``.
        """
        det = self.detector
        if calibration_tiles is not None:
            det.calibrate(np.asarray(calibration_tiles))
        elif det.precision.startswith("int8") and det._act_scales is None:
            import warnings

            warnings.warn(
                "warmup skipped: int8 precision with no calibration tiles. "
                "Warming up would calibrate activation scales on synthetic "
                "noise and silently degrade every request; deferring "
                "warm-up+calibration to the first real request instead. "
                "Pass calibration_tiles / --calibration_folder for a "
                "warmed-up, representatively-calibrated server.",
                UserWarning, stacklevel=2)
            return False
        side = (det.model_size if det.host_resize else det.tile_size)
        tile = np.random.RandomState(0).randint(
            0, 255, (side, side, 3)).astype(np.uint8)
        self.executor.submit(tile, timeout=1200.0, shed=False)
        return True

    # -- request plumbing -----------------------------------------------------

    def _to_tile_frame(self, img: np.ndarray) -> np.ndarray:
        """Square-pad + fill the tile frame (ImageFolder.__getitem__
        geometry, datasets.py) so border-sized inputs behave exactly like
        the folder path; then the optional host resize.

        The semantic chain is src → tile_size → model_size (two nearest
        gathers), but nearest gathers compose by index composition —
        ``img[i1][:, i1][i2][:, i2] == img[i1[i2]][:, i1[i2]]`` — so when
        host_resize is on, the tile-sized intermediate (7 MB at 1536²)
        is never materialized: one composed gather goes straight to
        model_size.  Bit-identical by construction (tested against the
        explicit two-step form)."""
        img, _ = pad_to_square_np(img)
        det = self.detector
        side = img.shape[0]
        if det.host_resize:
            if side != det.model_size or side != det.tile_size:
                idx = self._ridx(det.model_size, det.tile_size)
                if side != det.tile_size:
                    idx = self._ridx(det.tile_size, side)[idx]
                img = np.ascontiguousarray(img[idx][:, idx])
            return img
        if side != det.tile_size:
            idx = self._ridx(det.tile_size, side)
            img = np.ascontiguousarray(img[idx][:, idx])
        return img

    def _ridx(self, dst: int, src: int) -> np.ndarray:
        key = dst * 1000003 + src
        got = self._ridx_cache.get(key)
        if got is None:
            got = self._ridx_cache[key] = nearest_indices(dst, src)
        return got

    def _detect_one(self, body: bytes, merge: bool, caa: bool,
                    raw_shape: Optional[Tuple[int, int]] = None) -> dict:
        use_caa = caa and self.caa_filter is not None
        img = None
        tile = None
        if raw_shape is not None:
            # Raw-RGB ingestion (X-Image-Shape: H,W header): a co-located
            # tiler that already holds pixels skips the JPEG encode/decode
            # round trip, whose host-side Huffman decode bounds the JPEG
            # path (PERF.md, the serving rows).
            h, w = raw_shape
            if h <= 0 or w <= 0 or h * w * 3 != len(body):
                raise ValueError(
                    f"raw body is {len(body)} bytes but X-Image-Shape "
                    f"{h},{w} implies {h * w * 3} (uint8 RGB, C-order)")
            if max(h, w) > self.max_side:
                raise ValueError(
                    f"image side {max(h, w)} exceeds max_side="
                    f"{self.max_side} (pad-to-square would allocate "
                    f"{max(h, w) ** 2 * 3} bytes)")
            img = np.frombuffer(body, dtype=np.uint8).reshape(h, w, 3)
            tile = self._to_tile_frame(img)
            with self._native_lock:
                self._n_raw += 1
        if tile is None and self._native_ok and not use_caa:
            # Fast path: exact-tile JPEG, no CAA crops needed from the
            # original image.  Non-tile geometries are rejected by the C
            # side right after the JPEG header (cheap) → PIL fallback.
            dt = self.detector
            got = _native.decode_tile_bytes(
                body, dt.tile_size,
                resize_to=dt.model_size if dt.host_resize else 0,
                scale_denom=self._scale_denom)
            if got is not None:
                tile, (h, w) = got
                with self._native_lock:
                    self._n_native += 1
        if tile is None:
            from PIL import Image

            with Image.open(io.BytesIO(body)) as im:
                # check the header-declared size BEFORE decoding pixels:
                # a tall 1xN PNG must not allocate its padded square
                if max(im.size) > self.max_side:
                    raise ValueError(
                        f"image side {max(im.size)} exceeds max_side="
                        f"{self.max_side}")
                img = np.asarray(im.convert("RGB"))
            h, w = img.shape[:2]
            tile = self._to_tile_frame(img)
        det = self.executor.submit(tile, timeout=self.request_timeout_s)
        if det is not None and (h, w) != (self.detector.tile_size,) * 2:
            det = rescale_from_tile_frame(det, self.detector.tile_size, (h, w))
        if det is not None and merge:
            det = merge_detections(det)
        if det is not None and len(det) and use_caa:
            # CAAFilter array form: crops come from the request's own image,
            # detections already in its pixel space (the original applies
            # the filter after the rescale, core.py:432-444).  Request
            # threads run the classifier concurrently on the filter's device.
            det = self.caa_filter(img, det)
        rows = []
        for r in (det if det is not None and len(det) else []):
            cls = int(r[6])
            rows.append({
                "x1": float(r[0]), "y1": float(r[1]),
                "x2": float(r[2]), "y2": float(r[3]),
                "conf": float(r[4]), "cls_conf": float(r[5]), "cls": cls,
                "label": (self.class_names[cls]
                          if 0 <= cls < len(self.class_names) else str(cls)),
            })
        return {"detections": rows, "image_hw": [h, w]}

    def _stats(self) -> dict:
        ex = self.executor
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "requests": ex.n_requests,
            "dispatches": ex.n_dispatches,
            "errors": ex.n_errors,
            "batched_ratio": round(ex.n_requests / max(ex.n_dispatches, 1), 3),
            "batch_size": ex.batch_size,
            "queue_depth": ex.queue_depth(),
            "max_queue": ex.max_queue,
            "shed": ex.n_shed,
            "rejected_oversize": self.n_oversize,
            "precision": self.detector.precision,
            "native_decodes": self._n_native,
            "raw_requests": self._n_raw,
            "decode_scale_denom": self._scale_denom,
            # images whose conf-passing candidates exceeded the fixed NMS
            # pool (detections truncated vs the uncapped reference loop)
            "nms_pool_overflows": self.detector.overflow_images,
            # int8 calibration provenance (sidecar meta / folder hash) so
            # ops can tell WHICH gated scales a server is running
            "calibration": (getattr(self.detector, "_calib_meta", None)
                            if self.detector.precision.startswith("int8")
                            else None),
        }

    def _health(self) -> dict:
        dev = self.detector.device
        return {
            "status": "ok",
            "backend": dev.type,
            "devices": torch.cuda.device_count(),
            "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
            "warmed_up": self.executor.n_dispatches > 0,
        }

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, payload: dict,
                      extra_headers: Optional[dict] = None,
                      close: bool = False):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                if close:  # we are not reading the request body: don't
                    self.send_header("Connection", "close")  # reuse the conn
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._send(200, server._health())
                elif path == "/stats":
                    self._send(200, server._stats())
                else:
                    self._send(404, {"error": f"unknown path {path}"})

            def do_POST(self):
                url = urlparse(self.path)
                if url.path != "/v1/detect":
                    self._send(404, {"error": f"unknown path {url.path}"})
                    return
                q = parse_qs(url.query)

                def flag(name, default):
                    v = q.get(name, [None])[0]
                    return default if v is None else v not in ("0", "false", "False")

                try:
                    # Early shed: when the queue is already full, answer 503
                    # BEFORE reading/decoding the body — during overload the
                    # host-side JPEG decode is the scarce resource, and a
                    # request that will be shed anyway must not consume it
                    # (measured: decode-then-shed answered in ~3.9 s under
                    # 4x saturation; header-shed is ~instant).  The submit-
                    # time check below still guards the race where the queue
                    # fills between here and enqueue.
                    ex = server.executor
                    if ex.queue_depth() >= ex.max_queue:
                        ex.record_shed()
                        self._send(503, {"error": "queue full; retry later"},
                                   extra_headers={"Retry-After": "1"},
                                   close=True)
                        return
                    length = int(self.headers.get("Content-Length", "0"))
                    if length <= 0:
                        self._send(400, {"error": "empty body"})
                        return
                    if length > server.max_body_bytes:
                        # reject on the HEADER — never allocate what an
                        # adversarial Content-Length claims (one 10 GB POST
                        # must not be a one-request DoS)
                        server.record_oversize()
                        self._send(413, {
                            "error": f"payload {length} bytes exceeds "
                                     f"max_body_bytes={server.max_body_bytes}"},
                            close=True)
                        return
                    # Raw-RGB ingestion is keyed on the X-Image-Shape
                    # header alone (NOT on Content-Type: many clients
                    # already POST encoded images as octet-stream).
                    raw_shape = None
                    shp = self.headers.get("X-Image-Shape")
                    if shp is not None:
                        # split WITHOUT dropping empties: '64,,64' and
                        # '64,64,,' must be 400s, not silently accepted
                        parts = shp.replace(" ", "").split(",")
                        if (len(parts) not in (2, 3)
                                or not all(p.isdigit() for p in parts)
                                or (len(parts) == 3 and parts[2] != "3")):
                            self._send(400, {
                                "error": "raw body requires X-Image-Shape: "
                                         "H,W (uint8 RGB, C-order)"},
                                close=True)
                            return
                        raw_shape = (int(parts[0]), int(parts[1]))
                        if max(raw_shape) > server.max_side:
                            server.record_oversize()
                            self._send(413, {
                                "error": f"image side {max(raw_shape)} "
                                         f"exceeds max_side="
                                         f"{server.max_side}"},
                                close=True)
                            return
                    body = self.rfile.read(length)
                    out = server._detect_one(
                        body, flag("merge", server.merge_boxes),
                        flag("caa_filter", server.caa_filter is not None),
                        raw_shape=raw_shape)
                    self._send(200, out)
                except QueueFullError as e:  # shed: bounded queue is full
                    self._send(503, {"error": str(e)},
                               extra_headers={"Retry-After": "1"})
                except TimeoutError as e:
                    self._send(503, {"error": str(e)})
                except Exception as e:  # bad image, etc.
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

        return Handler


__all__ = ["DetectionServer", "BatchingExecutor", "QueueFullError"]
