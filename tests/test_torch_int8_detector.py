"""The port's int8 ``Detector`` against the JAX ``Detector`` as it runs:
compiled by ``jax.jit``, with its activation scales closed over as Python
floats.

Three forms: ``precision="int8_full"``, ``"int8_early"`` and ``"int8_full"``
with the s2d stem (on ``tests/test_torch_s2d.py:_stem8``'s spec, whose conv
1 is wide enough to quantize; the mini spec's is not, and both packages
refuse it).  Both detectors take the JAX scales through
``save_calibration``/``load_calibration``.

* Head maps: the JAX Detector's program compiled with XLA's
  ``xla_allow_excess_precision`` off (``torch_port_helpers.EXACT_BF16``)
  against the port's ``Detector.head_maps``: every int8 level equal, so
  the maps agree to the float32 order of the head convs (``HEAD_RTOL`` ×
  the map's largest value; one level off upstream moves a head value by
  ~1e-3 of the map).  The compiled program quantizes ``y / s`` as
  ``y · f32(1/s)`` (XLA folds the division by a constant), which the port
  does too (``ops/int8.py:quant``; ``tests/test_torch_int8.py::
  test_quant_matches_compiled_jax`` holds the rule itself).  With excess
  precision on, its default, XLA's CPU backend skips the program's bf16
  roundings, the int8 accumulators' among them, which a backend with bf16
  arithmetic keeps.
* Detections: the same compiled program, decode and NMS included (the
  Detector's ``_fn``), against the port's call: the same valid masks,
  classes and candidate counts, boxes within ``BOX_ATOL`` px and scores
  within ``SCORE_ATOL`` (``tests/test_torch_calibration.py::
  test_detections_match_jax_detector``'s bounds, which that test holds
  against the JAX Detector's own call under the default flags).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu import graphspec as jax_graphspec
from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.ops.preprocess import preprocess_tiles
from amyloid_yolo_tpu_torch import graphspec as port_graphspec
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels import launch_counts

from minispec import mini_spec
from test_torch_s2d import _stem8
from torch_port_helpers import jit_compiled, numpy_params, port_mini_spec

HEAD_RTOL = 1e-5
BOX_ATOL = 0.1
SCORE_ATOL = 1e-3

FORMS = {
    "int8_full": (lambda: (mini_spec(), port_mini_spec()), dict(precision="int8_full"), 0.3),
    "int8_early": (lambda: (mini_spec(), port_mini_spec()), dict(precision="int8_early"), 0.3),
    "int8_full_s2d": (lambda: (_stem8(jax_graphspec), _stem8(port_graphspec)),
                      dict(precision="int8_full", s2d_stem=True), 0.05),
}


def _jax_head_maps(ref: JaxDetector, tiles):
    """The head maps of ``ref``'s compiled program (its ``_build``, up to
    the decode), with its own constants."""
    def maps(params, t):
        x = preprocess_tiles(t, ref.model_size)
        if ref.precision == "int8_early":
            return jax_darknet.apply_folded_int8(
                params, ref._qparams, ref._act_scales, ref.spec, x, upto=ref._int8_upto,
                compute_dtype=ref.compute_dtype, int8_compute=ref.int8_compute)
        return jax_darknet.apply_folded_int8_full(
            params, ref._qparams, ref._act_scales, ref.spec, x,
            compute_dtype=ref.compute_dtype, s2d_stem=ref._s2d_params,
            s2d_downs=ref._s2d_downs, int32_accum_max_hw=ref.int32_accum_max_hw)

    return [np.asarray(m) for m in jit_compiled(maps, ref.params, tiles)]


def _close_dets(dets, valid, want_d, want_v):
    v = valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(want_v))
    assert v.sum() > 0
    want_d = np.asarray(want_d)
    np.testing.assert_allclose(dets.numpy()[v][:, :4], want_d[v][:, :4], atol=BOX_ATOL)
    np.testing.assert_allclose(dets.numpy()[v][:, 4:6], want_d[v][:, 4:6], atol=SCORE_ATOL)
    np.testing.assert_array_equal(dets.numpy()[v][:, 6], want_d[v][:, 6])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_int8_detector_matches_compiled_jax_detector(tmp_path, form):
    specs, kwargs, conf = FORMS[form]
    ref_spec, spec = specs()
    params = numpy_params(ref_spec, 3)
    cfg = dict(conf_thres=conf, nms_thres=0.4, model_size=64, tile_size=256, capacity=16,
               **kwargs)
    tiles = np.random.RandomState(7).randint(0, 255, (2, 256, 256, 3)).astype(np.uint8)
    ref = JaxDetector(ref_spec, params, **cfg)
    ref.calibrate(tiles)
    path = ref.save_calibration(str(tmp_path / "calib.json"))
    det = Detector(spec, params_from_jax(params, spec), device="cpu", **cfg)
    det.load_calibration(path)
    assert det._act_scales == ref._act_scales

    jt = jnp.asarray(tiles)
    got = det.head_maps(torch.from_numpy(tiles))
    want = _jax_head_maps(ref, jt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= HEAD_RTOL * np.abs(w).max()

    dets, valid = det(tiles)
    want_d, want_v, want_n = jit_compiled(ref._fn, ref.params, jt)
    _close_dets(dets, valid, want_d, want_v)
    np.testing.assert_array_equal(det._last_ncand.numpy(), np.asarray(want_n))
    assert launch_counts() == {"resize_normalize": 0, "fused_residual_block": 0,
                               "fused_residual_block_int8": 0}
