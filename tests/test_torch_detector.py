"""Port ``Detector`` against the golden detections and the JAX ``Detector``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.models import heads as jax_heads
from amyloid_yolo_tpu.ops import nms as jax_nms
from amyloid_yolo_tpu.ops.boxes import rescale_boxes_jnp
from amyloid_yolo_tpu.ops.preprocess import preprocess_tiles
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels import launch_counts

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mini_detections.npz")
# the golden config of tests/test_golden.py:26-34
CFG = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)


def _tiles():
    return np.random.RandomState(7).randint(0, 255, (2, 256, 256, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def golden_params():
    return jax_params_np(mini_spec(), 42)


def test_reproduces_golden_detections(golden_params):
    det = Detector(port_mini_spec(), params_from_jax(golden_params, port_mini_spec()),
                   compute_dtype=torch.float32, device="cpu", **CFG)
    dets, valid = det(_tiles())
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(valid.numpy(), g["valid"])
    # the tolerance tests/test_golden.py gives the JAX pipeline
    np.testing.assert_allclose(dets.numpy(), g["dets"], rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("lazy", [True, False])
def test_matches_jax_detector_f32(golden_params, lazy):
    ref = JaxDetector(mini_spec(), golden_params, compute_dtype=jnp.float32,
                      lazy_decode=lazy, **CFG)
    want_d, want_v = ref(_tiles())
    det = Detector(port_mini_spec(), params_from_jax(golden_params, port_mini_spec()),
                   compute_dtype=torch.float32, device="cpu", lazy_decode=lazy, **CFG)
    dets, valid = det(_tiles())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(det._last_ncand.numpy(), np.asarray(ref._last_ncand))


def test_bf16_pipeline_matches_jax_composition():
    """The port's main path (bf16, K1, K2 on every residual unit) against the
    JAX composition of the same stages: preprocess_tiles → bf16
    apply_folded with every unit in the Pallas kernel (interpret mode) →
    decode_topk → pooled NMS → rescale.  Same valid mask; boxes within 1 px
    and scores within 1e-2 (bf16 drift through the graph)."""
    params = jax_params_np(mini_spec(), 11, bn_noise=True)
    spec = mini_spec()
    folded = jax_darknet.fold_batchnorm(params, spec)
    tiles = _tiles()
    x = preprocess_tiles(jnp.asarray(tiles), 64)
    maps = jax_darknet.apply_folded(folded, spec, x, compute_dtype=jnp.bfloat16,
                                    pallas_packs=jax_darknet.pack_pallas_blocks(folded, spec),
                                    pallas_interpret=True)
    d, s, n = jax_heads.decode_topk(maps, spec, 64, 0.5, 16, return_count=True)
    want_d, want_v = jax_nms.non_max_suppression_pooled(d, s, 0.4, 16)
    want_d = np.asarray(rescale_boxes_jnp(want_d, 64, 256, 256))

    det = Detector(port_mini_spec(), params_from_jax(params, port_mini_spec()),
                   device="cpu", **{**CFG, "conf_thres": 0.5})
    dets, valid = det(tiles)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(det._last_ncand.numpy(), np.asarray(n))
    v = valid.numpy()
    np.testing.assert_allclose(dets.numpy()[v][:, :4], want_d[v][:, :4], atol=1.0)
    np.testing.assert_allclose(dets.numpy()[v][:, 4:6], want_d[v][:, 4:6], atol=1e-2)
    np.testing.assert_array_equal(dets.numpy()[v][:, 6], want_d[v][:, 6])
    assert launch_counts() == {"resize_normalize": 0, "fused_residual_block": 0,
                               "fused_residual_block_int8": 0}


def test_overflow_accounting(golden_params):
    """conf 0: every anchor row is a candidate, past the pool; padding rows
    (n_valid) are not counted; lazy and dense decode count alike."""
    counts = {}
    tiles = np.random.RandomState(0).randint(0, 255, (3, 64, 64, 3)).astype(np.uint8)
    for lazy in (False, True):
        det = Detector(port_mini_spec(), params_from_jax(golden_params, port_mini_spec()),
                       conf_thres=0.0, model_size=64, tile_size=64, capacity=8,
                       compute_dtype=torch.float32, host_resize=True, lazy_decode=lazy,
                       device="cpu")
        out = det.detect_batch_ragged(tiles, n_valid=2)
        assert len(out) == 3
        assert det.images_seen == 2 and det.overflow_images == 2
        assert det.max_candidates_seen == 3 * (4 ** 2 + 8 ** 2 + 16 ** 2) > det.nms_pool
        counts[lazy] = det.max_candidates_seen
    assert counts[False] == counts[True]


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(port_mini_spec())


@pytest.mark.parametrize("kwargs,match", [
    ({"s2d_stem": True}, "ROADMAP"),
    ({"pallas_blocks": True}, "ROADMAP"),
    ({"compute_dtype": torch.float16}, "compute_dtype"),
    ({"s2d_downsample": True}, "ROADMAP"),
    ({"precision": "int8_full", "fold_bn": False}, "requires fold_bn"),
    ({"precision": "fp8"}, "unknown precision"),
])
def test_rejects_unported_options(kwargs, match):
    with pytest.raises(ValueError, match=match):
        Detector(port_mini_spec(), device="cpu", **kwargs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfolded_matches_jax_detector(golden_params, dtype):
    """``fold_bn=False`` runs the unfolded executor (no K2), against the JAX
    ``Detector(fold_bn=False)``: same valid mask, classes and candidate
    counts; boxes within 1e-2 px in f32 and 1 px in bf16 (the JAX pipeline
    is compiled, so XLA fuses the bf16 BN epilogue differently)."""
    atol = {"float32": 1e-2, "bfloat16": 1.0}[dtype]
    params = jax_params_np(mini_spec(), 9, bn_noise=True)
    ref = JaxDetector(mini_spec(), params, fold_bn=False, compute_dtype=getattr(jnp, dtype),
                      **CFG)
    want_d, want_v = (np.asarray(a) for a in ref(_tiles()))
    det = Detector(port_mini_spec(), params_from_jax(params, port_mini_spec()),
                   fold_bn=False, compute_dtype=getattr(torch, dtype), device="cpu", **CFG)
    assert det.packs is None
    dets, valid = det(_tiles())
    v = valid.numpy()
    np.testing.assert_array_equal(v, want_v)
    np.testing.assert_array_equal(det._last_ncand.numpy(), np.asarray(ref._last_ncand))
    np.testing.assert_allclose(dets.numpy()[v][:, :4], want_d[v][:, :4], atol=atol)
    np.testing.assert_array_equal(dets.numpy()[v][:, 6], want_d[v][:, 6])


def test_host_resize_checks_tile_size():
    det = Detector(port_mini_spec(), device="cpu", model_size=64, host_resize=True)
    with pytest.raises(ValueError, match="host_resize"):
        det(np.zeros((1, 256, 256, 3), np.uint8))


@pytest.mark.parametrize("lazy", [True, False])
def test_approx_topk_matches_jax_detector(golden_params, lazy):
    """The reference's ``approx_topk=True`` (its CLI's ``--fast_path``)
    against the port, which always selects the pool exactly and has no such
    option: XLA on the CPU lowers ``approx_max_k`` to an exact top-k, so both
    agree at the bound of ``test_torch_calibration.py``'s
    ``test_detections_match_jax_detector`` (0.1 px, 1e-3 in score)."""
    ref = JaxDetector(mini_spec(), golden_params, compute_dtype=jnp.float32,
                      lazy_decode=lazy, approx_topk=True, **CFG)
    want_d, want_v = (np.asarray(a) for a in ref(_tiles()))
    det = Detector(port_mini_spec(), params_from_jax(golden_params, port_mini_spec()),
                   compute_dtype=torch.float32, device="cpu", lazy_decode=lazy, **CFG)
    dets, valid = det(_tiles())
    v = valid.numpy()
    np.testing.assert_array_equal(v, want_v)
    assert v.sum() > 0
    np.testing.assert_allclose(dets.numpy()[v][:, :4], want_d[v][:, :4], atol=0.1)
    np.testing.assert_allclose(dets.numpy()[v][:, 4:6], want_d[v][:, 4:6], atol=1e-3)
    np.testing.assert_array_equal(dets.numpy()[v][:, 6], want_d[v][:, 6])
    with pytest.raises(TypeError, match="approx_topk"):
        Detector(port_mini_spec(), device="cpu", approx_topk=True)
