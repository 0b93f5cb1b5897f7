"""The port's device mesh (``parallel/mesh.py``) and ``Detector(mesh=)``
against the one-device port ``Detector`` and the JAX ``Detector(mesh=)``
(the counterpart of ``tests/test_detector_dp.py``), the sweep's
``--data_parallel``, and the float32 ``Detector``'s route on the card.

A mesh of N CPU entries stands for the JAX suite's N virtual CPU devices.
Tolerances: port mesh against port one-device, 1e-5 (the same per-image
arithmetic); against the JAX mesh ``Detector``, float32 as
``test_torch_detector.py`` holds the one-device pair (rtol/atol 1e-4) and
int8_early as ``test_torch_calibration.py`` does (0.1 px, 1e-3 in score,
scales shared through a sidecar); ``valid`` equal everywhere.
"""

import pickle
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from amyloid_yolo_tpu_torch.analysis.validation import calculate_plaque_counts_per_wsi
from amyloid_yolo_tpu_torch.cli import main as cli
from amyloid_yolo_tpu_torch.detectors import Detector, Route, route
from amyloid_yolo_tpu_torch.graphspec import emit_cfg
from amyloid_yolo_tpu_torch.io import tiles as tiles_mod
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels import launch_counts
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch import detectors as detectors_mod
from amyloid_yolo_tpu_torch.parallel import mesh as mesh_mod
from amyloid_yolo_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, split_batch
from amyloid_yolo_tpu_torch.utils import device as device_mod

from minispec import mini_spec
from torch_port_helpers import copy_always, jax_params_np, port_mini_spec

CFG = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def params():
    return jax_params_np(mini_spec(), 0, jit=True)


def _tiles(seed=0, n=8):
    return np.random.RandomState(seed).randint(0, 255, (n, 256, 256, 3)).astype(np.uint8)


# -- the mesh ---------------------------------------------------------------

def test_make_mesh_validates():
    m = make_mesh(devices=CPU8)
    assert m.size == 8 and m.axis == "dp" and m.local_devices == m.devices
    assert all(d == torch.device("cpu") for d in m.devices)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="requested"):
        make_mesh(have + 1)
    with pytest.raises(ValueError, match="listed"):
        make_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(devices=["cpu", f"cuda:{have}"])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_batch_is_an_even_split(n):
    x = torch.arange(8 * 3).reshape(8, 3)
    parts = split_batch(x, make_mesh(devices=["cpu"] * n))
    assert len(parts) == n and all(p.shape == (8 // n, 3) for p in parts)
    assert torch.equal(torch.cat(parts), x)


def test_split_batch_raises_on_a_remainder():
    with pytest.raises(ValueError, match="must divide"):
        split_batch(torch.zeros(6, 2), make_mesh(devices=["cpu"] * 4))


def test_replicate_shares_one_device():
    t = torch.ones(3)
    copies = replicate({"a": t, "b": (t, None)}, make_mesh(devices=["cpu"] * 3))
    assert len(copies) == 3
    assert all(c["a"] is t and c["b"][0] is t and c["b"][1] is None for c in copies)


# -- Detector(mesh=) --------------------------------------------------------

def _port(params, **kw):
    spec = port_mini_spec()
    return Detector(spec, params_from_jax(params, spec), compute_dtype=torch.float32,
                    device="cpu", **{**CFG, **kw})


def test_mesh_detector_f32_matches_one_device_and_jax(params):
    tiles = _tiles()
    single = _port(params)
    dp = _port(params, mesh=make_mesh(devices=CPU8))
    d1, v1 = single(tiles)
    d2, v2 = dp(tiles)
    assert dp.device == torch.device("cpu") and len(dp._replicas) == 8
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dp._last_ncand.numpy(), single._last_ncand.numpy())
    assert v2.numpy().sum() > 0

    ref = JaxDetector(mini_spec(), params, mesh=jax_make_mesh(8), compute_dtype=jnp.float32,
                      **CFG)
    want_d, want_v = (np.asarray(a) for a in ref(tiles))
    np.testing.assert_array_equal(v2.numpy(), want_v)
    np.testing.assert_allclose(d2.numpy(), want_d, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(dp._last_ncand.numpy(), np.asarray(ref._last_ncand))
    assert launch_counts() == {"resize_normalize": 0, "fused_residual_block": 0,
                               "fused_residual_block_int8": 0}


def test_mesh_detector_through_copies(params, monkeypatch):
    """With copies between the devices, as on several cards (the weights,
    every shard's tiles and the gathered outputs): the same results as one
    device."""
    moved = copy_always(monkeypatch, mesh_mod, detectors_mod)
    tiles = _tiles(seed=3)
    d1, v1 = _port(params)(tiles)
    n_weights = len(moved)
    dp = _port(params, mesh=make_mesh(devices=["cpu"] * 4))
    assert len(moved) > n_weights
    calls = len(moved)
    d2, v2 = dp(tiles)
    assert len(moved) == calls + 4 + 3 * 4  # the tiles' shards, then dets, valid, n_cand
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=1e-5, atol=1e-5)


def test_mesh_detector_int8_early(tmp_path):
    """Lazy calibration on the whole first batch, on the first device; every
    shard uses those scales.  Against the JAX mesh ``Detector`` the scales
    are shared through its sidecar.  The weights are
    ``test_torch_calibration.py``'s (seed 3, random BN statistics): on
    seed 0's every int8_early score of these tiles is within 0.005 of 0.5,
    and a pool of 16 out of 1008 near-tied candidates is a tie order that
    the two packages' top-k need not share (the one-device pair differs
    there alike)."""
    tiles = _tiles(7)
    params = jax_params_np(mini_spec(), 3, bn_noise=True, jit=True)
    kw = dict(precision="int8_early")
    single = _port(params, **kw)
    dp = _port(params, mesh=make_mesh(devices=CPU8), **kw)
    d1, v1 = single(tiles)
    d2, v2 = dp(tiles)
    assert dp._act_scales == single._act_scales
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=1e-5, atol=1e-5)

    ref = JaxDetector(mini_spec(), params, mesh=jax_make_mesh(8), compute_dtype=jnp.float32,
                      **kw, **CFG)
    ref.calibrate(tiles)
    port = _port(params, mesh=make_mesh(devices=CPU8), **kw)
    port.load_calibration(ref.save_calibration(str(tmp_path / "calib.json")))
    want_d, want_v = (np.asarray(a) for a in ref(tiles))
    dets, valid = port(tiles)
    v = valid.numpy()
    np.testing.assert_array_equal(v, want_v)
    assert v.sum() > 0
    np.testing.assert_allclose(dets.numpy()[v][:, :4], want_d[v][:, :4], atol=0.1)
    np.testing.assert_allclose(dets.numpy()[v][:, 4:6], want_d[v][:, 4:6], atol=1e-3)
    np.testing.assert_array_equal(dets.numpy()[v][:, 6], want_d[v][:, 6])


def test_mesh_detector_rejects_another_device(params):
    with pytest.raises(ValueError, match="first device"):
        _port(params, mesh=Mesh((torch.device("meta"),)))


def test_mesh_sweep_counts_equal(params, tmp_path):
    """``calculate_plaque_counts_per_wsi`` over an 8-entry mesh counts what
    the one-device sweep counts."""
    root = tmp_path / "wsis"
    img = np.random.RandomState(0).randint(0, 255, (512, 512, 3)).astype(np.uint8)
    tiles_mod.tile_image_array(img, str(root), "WSI_DP", tile_size=256)
    c1 = calculate_plaque_counts_per_wsi(str(root), _port(params), prefix="S_",
                                         pickles_dir=str(tmp_path / "p1"), batch_size=8)
    c2 = calculate_plaque_counts_per_wsi(str(root), _port(params, mesh=make_mesh(devices=CPU8)),
                                         prefix="D_", pickles_dir=str(tmp_path / "p2"),
                                         batch_size=8)
    assert c1 == c2
    assert sum(c["Cored"] + c["CAA"] for c in c1.values()) > 0


@pytest.mark.parametrize("device", ["cpu", "cpu,cpu"])
def test_cli_sweep_data_parallel_counts_equal(params, tmp_path, device):
    """``sweep --data_parallel 2`` (two CPU entries, by type or listed)
    writes the one-device sweep's pickles."""
    spec = port_mini_spec()
    cfg = tmp_path / "mini.cfg"
    cfg.write_text(emit_cfg(spec))
    pth = tmp_path / "port.pth"
    torch.save(params_from_jax(params, spec), pth)
    img = np.random.RandomState(1).randint(0, 255, (1536, 3072, 3)).astype(np.uint8)
    tiles_mod.tile_image_array(img, str(tmp_path / "wsis"), "WSI_A", tile_size=1536)
    common = ["sweep", "--model_def", str(cfg), "--weights_path", str(pth), "--directory",
              str(tmp_path / "wsis"), "--conf_thres", "0.3", "--batch_size", "2"]
    out = {}
    for name, extra in (("one", ["--device", "cpu"]),
                        ("dp", ["--data_parallel", "2", "--device", device])):
        pk = tmp_path / name
        assert cli.main(common + ["--pickles_dir", str(pk), "--prefix", "P_"] + extra) == 0
        with open(pk / "P_WSI_plaque_counts_dictionary.pkl", "rb") as fh:
            out[name] = pickle.load(fh)
    assert out["one"] == out["dp"]
    assert sum(c["Cored"] + c["CAA"] for c in out["one"].values()) > 0
    with pytest.raises(ValueError, match="lists several"):
        cli.main(common + ["--device", "cpu,cpu"])


# -- float32 on the card: the route, checked without one --------------------

@pytest.mark.parametrize("args,want", [
    (("cuda", torch.float32), Route(k1=False, k2=False, tf32_off=True)),
    (("cuda", torch.bfloat16), Route(k1=True, k2=True, tf32_off=False)),
    (("cpu", torch.float32), Route(k1=False, k2=False, tf32_off=False)),
    (("cpu", torch.bfloat16), Route(k1=True, k2=True, tf32_off=False)),
    (("cuda", torch.float32, "int8_full"), Route(k1=False, k2=False, tf32_off=True)),
    (("cuda", torch.bfloat16, "int8_early"), Route(k1=True, k2=False, tf32_off=False)),
    (("cuda", torch.bfloat16, "bf16", False), Route(k1=True, k2=False, tf32_off=False)),
])
def test_route(args, want):
    assert route(*args) == want


def test_f32_call_runs_plain_units_with_tf32_off_and_restores(params, monkeypatch):
    """The constructor's route for float32: no K2 packs, the plain
    preprocess; a call on the card's route turns TF32 off around the
    forward and puts the flags back."""
    det = _port(params)
    assert det.packs is None and det.route == route("cpu", torch.float32)

    def no_k1(*a, **k):
        raise AssertionError("K1 on the float32 path")

    monkeypatch.setattr("amyloid_yolo_tpu_torch.detectors.resize_normalize", no_k1)
    det.route = route("cuda", torch.float32)  # the card's route, on the CPU
    seen = []
    apply_folded = darknet.apply_folded

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32, k.get("packs")))
        return apply_folded(*a, **k)

    monkeypatch.setattr(darknet, "apply_folded", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    want = _port(params)(_tiles(2, 2))
    got = det(_tiles(2, 2))
    # the CPU route leaves the flags alone; the card's turns TF32 off
    assert seen == [(True, True, None), (False, False, None)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_no_tf32_sections_overlap_across_threads(monkeypatch):
    """Two threads' sections that overlap: TF32 stays off until the last
    one leaves, and the flags return to what they were before the first."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def first():
        with device_mod.no_tf32():
            a_in.set()
            b_in.wait(10)
        seen["after_a"] = torch.backends.cudnn.allow_tf32
        a_out.set()

    def second():
        a_in.wait(10)
        with device_mod.no_tf32():
            b_in.set()
            a_out.wait(10)
            seen["inside_b"] = torch.backends.cudnn.allow_tf32

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"after_a": False, "inside_b": False}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_no_tf32_under_thread_switches(monkeypatch):
    """16 threads (more than the cores), a 1 µs switch interval, 300
    sections each: no thread ever sees TF32 on inside a section, and the
    flags end as they began (a save and restore per section breaks both)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    bad = []

    def worker():
        for _ in range(300):
            with device_mod.no_tf32():
                if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                    bad.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
