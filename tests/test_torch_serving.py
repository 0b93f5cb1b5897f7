"""The port's serving path (``amyloid_yolo_tpu_torch/serving.py``) against the
JAX package's ``DetectionServer``, and the executor's behaviour.

The differential test runs a port server and a JAX server on the same mini
weights (``mini_spec(img_size=64)``, tile 256, capacity 16, conf 0.3, float32
on the CPU) with the same CAA classifier, and sends both the same requests:
the same status codes, the same JSON keys and ``image_hw``, and detections
within ``BOX_ATOL`` px and ``SCORE_ATOL`` in score.  Every socket wait has a
timeout of at most 30 s, and every server stops in its fixture's finalizer.
"""

import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.domain import CAAFilter as JaxCAAFilter
from amyloid_yolo_tpu.io.datasets import pad_to_square_np
from amyloid_yolo_tpu.ops.preprocess import nearest_indices
from amyloid_yolo_tpu.serving import DetectionServer as JaxServer
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.domain import CAAFilter
from amyloid_yolo_tpu_torch.io import native
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels import launch_counts
from amyloid_yolo_tpu_torch.models import classifier
from amyloid_yolo_tpu_torch.serving import BatchingExecutor, DetectionServer, QueueFullError

from minispec import mini_spec
from torch_port_helpers import jax_classifier_params, jax_params_np, port_mini_spec, stain_tile

BOX_ATOL = 0.1
SCORE_ATOL = 1e-3
TIMEOUT = 30
CFG = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)


def _encode(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _request(port, method, path, body=None, headers=None):
    """(status, headers, JSON payload); HTTP errors are answers too."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _post_claiming(port, length):
    """POST a token body under a ``Content-Length`` of ``length``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.putrequest("POST", "/v1/detect")
        conn.putheader("Content-Length", str(length))
        conn.endheaders()
        conn.send(b"x" * 10)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _rows(out):
    return np.array([[r["x1"], r["y1"], r["x2"], r["y2"], r["conf"], r["cls_conf"],
                      r["cls"]] for r in out["detections"]], np.float64).reshape(-1, 7)


@pytest.fixture(scope="module")
def weights():
    return jax_params_np(mini_spec(), 4, jit=True), jax_classifier_params(3, fc_scale=8.0)


def _port_server(weights, **kw):
    params, cparams = weights
    spec = port_mini_spec()
    det = Detector(spec, params_from_jax(params, spec), device="cpu",
                   compute_dtype=torch.float32, **CFG)
    caa = CAAFilter(classifier.from_jax_params(cparams), device="cpu")
    return DetectionServer(det, ["CAA", "Cored"], port=0, batch_size=4, max_wait_ms=20.0,
                           caa_filter=caa, **kw)


@pytest.fixture(scope="module")
def servers(weights):
    params, cparams = weights
    jdet = JaxDetector(mini_spec(), params, compute_dtype=jnp.float32, **CFG)
    jsrv = JaxServer(jdet, ["CAA", "Cored"], port=0, batch_size=4, max_wait_ms=20.0,
                     caa_filter=JaxCAAFilter(cparams))
    psrv = _port_server(weights)
    started = []
    try:
        for s in (jsrv, psrv):
            s.start()
            started.append(s)
            assert s.warmup()
        yield psrv, jsrv
    finally:
        for s in started:
            s.stop()


def _request_matrix():
    rng = np.random.RandomState(11)
    tile = stain_tile(rng, 256, 256)
    tile2 = stain_tile(rng, 256, 256)
    border = stain_tile(rng, 100, 80)
    raw_h = {"X-Image-Shape": "256,256"}
    return [
        ("png tile", "/v1/detect", _encode(tile, "PNG"), {}),
        ("jpeg tile", "/v1/detect", _encode(tile2, "JPEG", quality=90), {}),
        ("jpeg tile, no filter", "/v1/detect?caa_filter=0",
         _encode(tile2, "JPEG", quality=90), {}),
        ("png border 100x80", "/v1/detect", _encode(border, "PNG"), {}),
        ("raw tile", "/v1/detect", tile.tobytes(), raw_h),
        ("raw border", "/v1/detect", border.tobytes(), {"X-Image-Shape": "100,80"}),
        ("raw H,W,3", "/v1/detect", border.tobytes(), {"X-Image-Shape": "100,80,3"}),
        ("merge=0 caa_filter=0", "/v1/detect?merge=0&caa_filter=0", tile.tobytes(), raw_h),
        ("merge=0", "/v1/detect?merge=0", _encode(tile, "PNG"), {}),
        ("raw wrong byte count", "/v1/detect", tile.tobytes()[:-3], raw_h),
        ("raw 64,,64", "/v1/detect", tile.tobytes(), {"X-Image-Shape": "64,,64"}),
        ("raw 64,64,4", "/v1/detect", tile.tobytes(), {"X-Image-Shape": "64,64,4"}),
        ("not an image", "/v1/detect", b"not an image", {}),
        ("empty body", "/v1/detect", b"", {}),
        ("max_side on a raw header", "/v1/detect", np.zeros(65535 * 3, np.uint8).tobytes(),
         {"X-Image-Shape": "65535,1"}),
        ("max_side on a decoded image", "/v1/detect",
         _encode(np.zeros((257, 2, 3), np.uint8), "PNG"), {}),
        ("unknown path", "/nope", b"x", {}),
    ]


def test_served_answers_match_the_jax_server(servers):
    psrv, jsrv = servers
    n_boxes = 0
    for name, path, body, headers in _request_matrix():
        pc, ph, pout = _request(psrv.port, "POST", path, body, headers)
        jc, jh, jout = _request(jsrv.port, "POST", path, body, headers)
        assert pc == jc, (name, pc, jc, pout, jout)
        assert sorted(pout) == sorted(jout), name
        if pc != 200:
            continue
        assert pout["image_hw"] == jout["image_hw"], name
        assert len(pout["detections"]) == len(jout["detections"]), name
        for p, j in zip(pout["detections"], jout["detections"]):
            assert sorted(p) == sorted(j) and (p["cls"], p["label"]) == (j["cls"], j["label"])
        got, want = _rows(pout), _rows(jout)
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=BOX_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[:, 4:6], want[:, 4:6], atol=SCORE_ATOL, rtol=0,
                                   err_msg=name)
        n_boxes += len(got)
    assert n_boxes > 10
    # the exact-tile JPEG without the filter took the native reader where it
    # is built; the four accepted raw bodies were counted
    assert psrv._n_native == (1 if native.available() else 0)
    assert psrv._n_raw == 4
    pc, pout = _post_claiming(psrv.port, psrv.max_body_bytes + 1)
    jc, jout = _post_claiming(jsrv.port, jsrv.max_body_bytes + 1)
    assert pc == jc == 413 and sorted(pout) == sorted(jout)
    assert _request(psrv.port, "GET", "/nope")[0] == _request(jsrv.port, "GET", "/nope")[0] == 404
    assert launch_counts() == {"resize_normalize": 0, "fused_residual_block": 0,
                               "fused_residual_block_int8": 0}


def test_stats_keys_match_and_healthz_reports_the_torch_device(servers):
    psrv, jsrv = servers
    pc, _, pstats = _request(psrv.port, "GET", "/stats")
    jc, _, jstats = _request(jsrv.port, "GET", "/stats")
    assert pc == jc == 200 and sorted(pstats) == sorted(jstats)
    assert pstats["calibration"] is None and pstats["precision"] == "bf16"
    code, _, health = _request(psrv.port, "GET", "/healthz")
    assert code == 200
    assert health == {"status": "ok", "backend": "cpu", "devices": torch.cuda.device_count(),
                      "device_name": "cpu", "warmed_up": True}


@pytest.mark.parametrize("host_resize", [False, True])
def test_to_tile_frame_is_bit_identical_to_jax(weights, host_resize):
    params, _ = weights
    spec = port_mini_spec()
    det = Detector(spec, params_from_jax(params, spec), device="cpu",
                   compute_dtype=torch.float32, host_resize=host_resize, **CFG)
    jdet = JaxDetector(mini_spec(), params, compute_dtype=jnp.float32,
                       host_resize=host_resize, **CFG)
    srv, jsrv = DetectionServer(det, port=0), JaxServer(jdet, port=0)
    rng = np.random.RandomState(5)
    try:
        shapes = [(256, 256), (100, 80), (64, 64), (300, 300), (256, 100)]
        shapes += [tuple(int(v) for v in rng.randint(1, 400, 2)) for _ in range(8)]
        for shape in shapes:
            img = rng.randint(0, 255, shape + (3,)).astype(np.uint8)
            got = srv._to_tile_frame(img)
            np.testing.assert_array_equal(got, jsrv._to_tile_frame(img))
            # and the explicit two-step gather src -> tile -> model
            ref, _ = pad_to_square_np(img)
            if ref.shape[0] != 256:
                i1 = nearest_indices(256, ref.shape[0])
                ref = ref[i1][:, i1]
            if host_resize:
                i2 = nearest_indices(64, 256)
                ref = ref[i2][:, i2]
            np.testing.assert_array_equal(got, ref)
    finally:
        srv._httpd.server_close()
        jsrv._httpd.server_close()


def test_concurrent_requests_share_dispatches(servers):
    psrv, _ = servers
    before = psrv.executor.n_dispatches
    body = _encode(stain_tile(np.random.RandomState(2), 256, 256), "PNG")
    results, errs = [], []

    def go():
        try:
            results.append(_request(psrv.port, "POST", "/v1/detect", body))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=go) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errs and len(results) == 12 and all(c == 200 for c, _, _ in results)
    assert all(out == results[0][2] for _, _, out in results)
    used = psrv.executor.n_dispatches - before
    assert used <= 8, f"expected micro-batching, got {used} dispatches"


class _Recorder:
    """A detector stand-in: records each dispatch's grad mode and thread."""

    def __init__(self, fail_first=False):
        self.fail_first = fail_first
        self.calls = []

    def detect_batch_ragged(self, batch, n_valid=None):
        self.calls.append((torch.is_inference_mode_enabled(), threading.current_thread().name,
                           len(batch), n_valid))
        if self.fail_first and len(self.calls) == 1:
            raise RuntimeError("injected device failure")
        return [None] * len(batch)


def test_executor_dispatches_under_inference_mode_in_its_own_thread():
    rec = _Recorder()
    ex = BatchingExecutor(rec, batch_size=3, max_wait_ms=1.0).start()
    try:
        assert not torch.is_inference_mode_enabled()
        assert ex.submit(np.zeros((8, 8, 3), np.uint8), timeout=TIMEOUT) is None
    finally:
        ex.stop()
    assert rec.calls == [(True, "amyolo-batcher", 3, 1)]


def test_executor_survives_device_error():
    rec = _Recorder(fail_first=True)
    ex = BatchingExecutor(rec, batch_size=2, max_wait_ms=1.0).start()
    try:
        tile = np.zeros((8, 8, 3), np.uint8)
        with pytest.raises(RuntimeError, match="injected"):
            ex.submit(tile, timeout=TIMEOUT)
        assert ex.submit(tile, timeout=TIMEOUT) is None
        assert ex.n_errors == 1 and ex.n_dispatches == 1
    finally:
        ex.stop()


def test_warmup_refuses_noise_calibration_for_int8(weights):
    params, _ = weights
    spec = port_mini_spec()
    det = Detector(spec, params_from_jax(params, spec), device="cpu", precision="int8_full",
                   compute_dtype=torch.float32, **CFG)
    srv = DetectionServer(det, ["CAA", "Cored"], port=0, batch_size=2)
    srv.start()
    try:
        with pytest.warns(UserWarning, match="calibration"):
            assert srv.warmup() is False
        assert det._act_scales is None and srv.executor.n_dispatches == 0
        assert _request(srv.port, "GET", "/healthz")[2]["warmed_up"] is False
        calib = np.random.RandomState(1).randint(0, 255, (2, 256, 256, 3)).astype(np.uint8)
        assert srv.warmup(calib) is True
        assert det._act_scales is not None and srv.executor.n_dispatches == 1
    finally:
        srv.stop()


class _SlowDet:
    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def detect_batch_ragged(self, batch, n_valid=None):
        self.entered.set()
        self.release.wait(TIMEOUT)
        return [None] * len(batch)


def test_timed_out_request_is_cancelled_not_dispatched():
    slow = _SlowDet()
    ex = BatchingExecutor(slow, batch_size=1, max_wait_ms=1.0, max_queue=8).start()
    try:
        tile = np.zeros((8, 8, 3), np.uint8)
        ta = threading.Thread(target=lambda: ex.submit(tile, timeout=TIMEOUT), daemon=True)
        ta.start()
        assert slow.entered.wait(10)
        with pytest.raises(TimeoutError):
            ex.submit(tile, timeout=0.2)
        assert ex.queue_depth() == 0
        slow.release.set()
        ta.join(TIMEOUT)
        deadline = time.time() + 5
        while ex.n_dispatches < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert ex.n_dispatches == 1
        assert ex.submit(tile, timeout=TIMEOUT) is None
        assert ex.n_dispatches == 2
    finally:
        slow.release.set()
        ex.stop()


def test_executor_sheds_on_bounded_queue():
    slow = _SlowDet()
    ex = BatchingExecutor(slow, batch_size=2, max_wait_ms=1.0, max_queue=4).start()
    waiters = []
    try:
        tile = np.zeros((8, 8, 3), np.uint8)

        def one():
            t = threading.Thread(target=lambda: ex.submit(tile, timeout=TIMEOUT), daemon=True)
            t.start()
            waiters.append(t)

        one()
        assert slow.entered.wait(10)
        for _ in range(4):
            one()
        deadline = time.time() + 10
        while ex.queue_depth() < 4 and time.time() < deadline:
            time.sleep(0.01)
        assert ex.queue_depth() == 4
        with pytest.raises(QueueFullError, match="queue full"):
            ex.submit(tile, timeout=TIMEOUT)
        assert ex.n_shed == 1
        slow.release.set()
        for t in waiters:
            t.join(TIMEOUT)
        assert ex.submit(tile, timeout=TIMEOUT) is None
        assert ex.n_shed == 1
    finally:
        slow.release.set()
        ex.stop()


def test_burst_gets_503_with_retry_after_and_stats_count_it(weights):
    """A server whose device is held: requests past ``max_queue`` are shed
    with 503 + Retry-After (at the header or at submit), and ``/stats``
    ``shed`` counts exactly those answers."""
    srv = _port_server(weights, max_queue=2)
    slow = _SlowDet()
    srv.executor.detector = slow
    srv.start()
    body = stain_tile(np.random.RandomState(3), 256, 256).tobytes()
    answers, threads = [], []

    def go():
        answers.append(_request(srv.port, "POST", "/v1/detect?caa_filter=0", body,
                                {"X-Image-Shape": "256,256"}))

    try:
        threads.append(threading.Thread(target=go, daemon=True))
        threads[0].start()
        assert slow.entered.wait(10)
        for _ in range(8):
            threads.append(threading.Thread(target=go, daemon=True))
            threads[-1].start()
        deadline = time.time() + 10
        while len(answers) < 6 and time.time() < deadline:
            time.sleep(0.01)
        slow.release.set()
        for t in threads:
            t.join(TIMEOUT)
        codes = sorted(c for c, _, _ in answers)
        shed = [(h, out) for c, h, out in answers if c == 503]
        assert len(answers) == 9 and set(codes) == {200, 503}
        assert codes.count(200) == 3 and len(shed) == 6
        assert all(h.get("Retry-After") == "1" and "queue full" in out["error"]
                   for h, out in shed)
        stats = _request(srv.port, "GET", "/stats")[2]
        assert stats["shed"] == len(shed) and stats["max_queue"] == 2
        code, out = _post_claiming(srv.port, srv.max_body_bytes + 1)
        assert code == 413 and "max_body_bytes" in out["error"]
        assert _request(srv.port, "GET", "/stats")[2]["rejected_oversize"] == 1
    finally:
        slow.release.set()
        srv.stop()
