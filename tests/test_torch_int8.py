"""The port's int8 executors against the JAX package's, on shared numpy
inputs and under shared activation scales.

* Region and quantized-conv sets, and the quantized weights: identical.
* Calibrated scales: ``SCALE_RTOL``.  Both probes run in float32 but sum
  the convolutions in another order, so a layer's max moves by float32
  ulps (measured: at most 1.2e-7 relative on ``mini_spec``).
* Head maps, both executors fed the JAX scales: every int8 level equal, so
  the maps differ only by the float32 summation order of the head convs
  (``HEAD_RTOL`` × the map's largest value; measured: up to 3e-7, and 0 in
  bf16 for ``int8_early``).  One int8 level off anywhere upstream moves a
  head value by about ``s·ws·|w|``, some 1e-3 of the map, so the
  tolerance catches any level that differs.  The JAX executors run as the
  JAX ``Detector`` compiles them: ``jax.jit``, the scales closed over as
  Python floats, XLA's excess precision off
  (``torch_port_helpers.jit_compiled``).  XLA then quantizes ``y / s`` as
  ``y · f32(1/s)``, which ``test_quant_matches_compiled_jax`` holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.graphspec import yolov3_spec as jax_yolov3_spec
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet as port_darknet
from amyloid_yolo_tpu_torch.ops import int8 as q8

from minispec import mini_spec
from torch_port_helpers import jax_params_np, jit_compiled, port_mini_spec

SCALE_RTOL = 1e-6
HEAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    ref_spec, spec = mini_spec(), port_mini_spec()
    params = jax_params_np(ref_spec, 3, bn_noise=True)
    ref_folded = jax_darknet.fold_batchnorm(params, ref_spec)
    folded = port_darknet.fold_batchnorm(params_from_jax(params, spec), spec)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    return ref_spec, spec, ref_folded, folded, x


def _close_maps(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= HEAD_RTOL * np.abs(w).max()


def test_region_and_quantized_sets():
    for ref_spec, spec in ((mini_spec(), port_mini_spec()),
                           (jax_yolov3_spec(num_classes=2), yolov3_spec(num_classes=2))):
        for d in (1, 2, 4, 8):
            assert port_darknet.int8_region(spec, d) == jax_darknet.int8_region(ref_spec, d)
        assert port_darknet.int8_full_conv_indices(spec) == jax_darknet.int8_full_conv_indices(
            ref_spec)


@pytest.mark.parametrize("kind", ["early", "full"])
def test_quantized_weights_bit_identical(model, kind):
    ref_spec, spec, ref_folded, folded, _ = model
    if kind == "early":
        upto = jax_darknet.int8_region(ref_spec)
        want = jax_darknet.quantize_folded_int8(ref_folded, ref_spec, upto)
        got = port_darknet.quantize_folded_int8(folded, spec, upto)
    else:
        want = jax_darknet.quantize_folded_int8_full(ref_folded, ref_spec)
        got = port_darknet.quantize_folded_int8_full(folded, spec)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k]["wq"].dtype == torch.int8
        np.testing.assert_array_equal(got[k]["wq"].numpy(),
                                      np.asarray(w["wq"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[k]["ws"].numpy(), np.asarray(w["ws"]))
        np.testing.assert_array_equal(got[k]["b"].numpy(), np.asarray(w["b"]))


@pytest.mark.parametrize("kind", ["early", "full"])
@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_calibrated_scales(model, kind, percentile):
    ref_spec, spec, ref_folded, folded, x = model
    if kind == "early":
        upto = jax_darknet.int8_region(ref_spec)
        want = jax_darknet.calibrate_act_scales(ref_folded, ref_spec, jnp.asarray(x), upto,
                                                percentile=percentile)
        got = port_darknet.calibrate_act_scales(folded, spec, torch.from_numpy(x), upto,
                                                percentile=percentile)
    else:
        want = jax_darknet.calibrate_act_scales_full(ref_folded, ref_spec, jnp.asarray(x),
                                                     percentile=percentile)
        got = port_darknet.calibrate_act_scales_full(folded, spec, torch.from_numpy(x),
                                                     percentile=percentile)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=SCALE_RTOL), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_compute", [True, False])
def test_apply_folded_int8_matches_jax(model, dtype, int8_compute):
    ref_spec, spec, ref_folded, folded, x = model
    upto = jax_darknet.int8_region(ref_spec)
    qp = jax_darknet.quantize_folded_int8(ref_folded, ref_spec, upto)
    scales = jax_darknet.calibrate_act_scales(ref_folded, ref_spec, jnp.asarray(x), upto)
    want = jit_compiled(lambda f, v: jax_darknet.apply_folded_int8(
        f, qp, scales, ref_spec, v, upto=upto, compute_dtype=getattr(jnp, dtype),
        int8_compute=int8_compute), ref_folded, jnp.asarray(x))
    got = port_darknet.apply_folded_int8(
        folded, port_darknet.quantize_folded_int8(folded, spec, upto), scales, spec,
        torch.from_numpy(x), upto=upto, compute_dtype=getattr(torch, dtype),
        int8_compute=int8_compute)
    _close_maps(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int32_accum_max_hw", [0, 10 ** 6])
def test_apply_folded_int8_full_matches_jax(model, dtype, int32_accum_max_hw):
    ref_spec, spec, ref_folded, folded, x = model
    qp = jax_darknet.quantize_folded_int8_full(ref_folded, ref_spec)
    scales = jax_darknet.calibrate_act_scales_full(ref_folded, ref_spec, jnp.asarray(x))
    want = jit_compiled(lambda f, v: jax_darknet.apply_folded_int8_full(
        f, qp, scales, ref_spec, v, compute_dtype=getattr(jnp, dtype),
        int32_accum_max_hw=int32_accum_max_hw), ref_folded, jnp.asarray(x))
    got = port_darknet.apply_folded_int8_full(
        folded, port_darknet.quantize_folded_int8_full(folded, spec), scales, spec,
        torch.from_numpy(x), compute_dtype=getattr(torch, dtype),
        int32_accum_max_hw=int32_accum_max_hw)
    _close_maps(got, want)


def test_s2d_stems_not_ported(model):
    """The int8 s2d stem reuses conv 1's int8 weights, so it is refused
    where conv 1 is not quantized (the mini spec's 4-channel conv 1), as
    the JAX ``make_s2d_stem_int8`` refuses it; ``tests/test_torch_s2d.py``
    holds the stem where it applies."""
    ref_spec, spec, ref_folded, folded, x = model
    qp = port_darknet.quantize_folded_int8_full(folded, spec)
    with pytest.raises(ValueError, match="conv_1 is not quantized"):
        jax_darknet.make_s2d_stem_int8(
            ref_folded, jax_darknet.quantize_folded_int8_full(ref_folded, ref_spec), ref_spec)
    with pytest.raises(ValueError, match="conv_1 is not quantized"):
        port_darknet.make_s2d_stem_int8(folded, qp, spec)


def test_quant_matches_compiled_jax():
    """``quant`` against the reference executors' ``quant`` compiled with
    its scale a Python float, over 2**20 values at 16 scales: every level
    equal.  True division, the rule before (and eager JAX's), flips some;
    so does ``1/s`` folded in double (K3's ``requant``)."""
    rng = np.random.RandomState(5)
    flips = {"quant": 0, "divide": 0, "requant": 0}
    for _ in range(16):
        s = float(rng.rand()) * 0.5 / 127.0 + 1e-12
        y = (rng.randn(1 << 20) * 40 * s).astype(np.float32)  # ~40 levels wide
        yt = torch.from_numpy(y)
        want = jit_compiled(lambda v: jnp.clip(jnp.round(v / s), -127, 127).astype(jnp.int8),
                            y)
        want = torch.from_numpy(np.array(want))
        inv = q8.inverse_scales({"s": s}, torch.device("cpu"))["s"]
        divided = torch.clamp(torch.round(yt / torch.tensor(s, dtype=torch.float32)), -127, 127)
        flips["quant"] += int((q8.quant(yt, inv) != want).sum())
        flips["divide"] += int((divided.to(torch.int8) != want).sum())
        flips["requant"] += int((q8.requant(yt, s) != want).sum())
    assert flips["quant"] == 0, flips
    assert flips["divide"] > 0 and flips["requant"] > 0, flips


@pytest.mark.parametrize("kernel,stride", [(2, 1), (2, 2), (3, 1)])
def test_maxpool_int8_matches_jax(kernel, stride):
    q = np.random.RandomState(2).randint(-128, 128, (2, 9, 8, 4)).astype(np.int8)
    want = np.asarray(jax_darknet._maxpool_int8(jnp.asarray(q), kernel, stride))
    got = q8.maxpool_int8(torch.from_numpy(q), kernel, stride)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_upsample_int8_matches_jax():
    q = np.random.RandomState(3).randint(-127, 128, (2, 3, 5, 4)).astype(np.int8)
    want = np.asarray(jax_darknet._upsample(jnp.asarray(q), 2))
    np.testing.assert_array_equal(q8.upsample_int8(torch.from_numpy(q), 2).numpy(), want)


@pytest.mark.parametrize("stride,pad,c", [(1, 1, 16), (2, 1, 8), (1, 1, 3), (1, 0, 24)])
def test_conv_int8_is_the_exact_integer_conv(stride, pad, c):
    """Nine shifted GEMMs (or one im2col GEMM for C % 8 != 0, or one GEMM
    for a 1×1) against an int64 convolution of the same integers."""
    rng = np.random.RandomState(4)
    k = 1 if pad == 0 else 3
    x = rng.randint(-127, 128, (2, 9, 7, c)).astype(np.int8)
    w = rng.randint(-127, 128, (12, c, k, k)).astype(np.int8)
    got = q8.conv_int8(torch.from_numpy(x), torch.from_numpy(w), stride, pad)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2).double(), torch.from_numpy(w).double(),
        stride=stride, padding=pad).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int64))
