"""The port's space-to-depth (s2d) inference options against the JAX
package's (``models/darknet.py:492-765``, ``detectors.py:165-196``).

* The fold-time weight transforms and the s2d rearrangement: bit-exact
  (the port's OIHW weights transposed to the reference's HWIO).
* ``s2d_stem_forward`` and ``apply_folded(s2d_stem=)`` in float32: within
  rtol/atol 1e-4 of JAX's, and of the port's own plain stem (the same
  function up to summation order, ``tests/test_s2d_stem.py:86-87``).
* ``int8_full`` with the s2d stem, both executors fed the JAX scales: head
  maps within 0.02 of the map's largest value, and the int8 levels of the
  stem's two outputs counted against JAX's (a level flips where conv_a's
  float32 sum lands on a rounding boundary in another order).  The JAX int8
  references run as ``tests/test_torch_int8.py``'s do, as the JAX
  ``Detector`` compiles them: ``jax.jit`` with the scales closed over as
  Python floats, so XLA multiplies by the reciprocal of each constant
  scale, as the port does, and XLA's excess precision off
  (``torch_port_helpers.jit_compiled``).
* The s2d downsample under int32 accumulation: bit-exact to the port's
  plain conv; against JAX within ``HEAD_RTOL`` (the head convs' float32
  order).
* ``Detector(s2d_stem=True)`` in float32 against JAX's: the same valid mask,
  boxes within 1e-3; the ``ValueError``\\ s where JAX raises them.

The specs are ``mini_spec`` and ``_stem8_spec``'s shape (a conv 1 wide
enough for ``int8_full`` to quantize it), built with each package's own
builder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu import graphspec as jax_graphspec
from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch import graphspec as port_graphspec
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels.conv_block import fused_residual_block_plain
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.parallel.mesh import make_mesh

from minispec import mini_spec
from torch_port_helpers import jit_compiled, numpy_params, port_mini_spec

F32_TOL = 1e-4
INT8_TOL = 0.02
HEAD_RTOL = 1e-5


def _stem8(gs, img=64):
    """``tests/test_s2d_stem.py:_stem8_spec`` with the builder of ``gs``."""
    b = gs._Builder(gs.NetInfo(width=img, height=img))
    b.conv(8, 3)
    b.conv(16, 3, stride=2)
    b.conv(8, 1)
    b.conv(16, 3)
    b.shortcut(-3)
    b.conv(3 * (5 + 2), 1, bn=False, act="linear")
    b.yolo(gs.YOLOV3_MASKS[0], 2)
    return gs._finish(b.net, b.layers, b.out_channels)


def _down(gs, img=64):
    """``tests/test_s2d_stem.py:_down_spec``: a second, non-stem 3x3/s2
    conv with 16 input channels, the shape class of YOLOv3's conv 5."""
    b = gs._Builder(gs.NetInfo(width=img, height=img))
    b.conv(8, 3)
    b.conv(16, 3, stride=2)
    b.conv(32, 3, stride=2)
    b.conv(3 * (5 + 2), 1, bn=False, act="linear")
    b.yolo(gs.YOLOV3_MASKS[0], 2)
    return gs._finish(b.net, b.layers, b.out_channels)


def _model(build, seed):
    ref_spec, spec = build(jax_graphspec), build(port_graphspec)
    params = numpy_params(ref_spec, seed)
    ref_folded = jax_darknet.fold_batchnorm(params, ref_spec)
    folded = darknet.fold_batchnorm(params_from_jax(params, spec), spec)
    x = np.random.RandomState(seed).rand(2, 64, 64, 3).astype(np.float32)
    return ref_spec, spec, params, ref_folded, folded, x


@pytest.fixture(scope="module")
def mini():
    return _model(lambda gs: mini_spec() if gs is jax_graphspec else port_mini_spec(), 0)


@pytest.fixture(scope="module")
def stem8():
    return _model(_stem8, 1)


@pytest.fixture(scope="module")
def down():
    return _model(_down, 3)


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.numpy().transpose(2, 3, 1, 0)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / (np.abs(want).max() + 1e-6))


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(1).rand(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(jax_darknet._space_to_depth(jnp.asarray(x)))
    np.testing.assert_array_equal(darknet._space_to_depth(torch.from_numpy(x)).numpy(), want)
    q = np.random.RandomState(2).randint(-127, 128, (1, 4, 4, 16)).astype(np.int8)
    np.testing.assert_array_equal(darknet._space_to_depth(torch.from_numpy(q)).numpy(),
                                  np.asarray(jax_darknet._space_to_depth(jnp.asarray(q))))


def test_fold_time_transforms_bitexact(mini, stem8):
    for ref_spec, spec, _, ref_folded, folded, _ in (mini, stem8):
        want = jax_darknet.make_s2d_stem(ref_folded, ref_spec)
        got = darknet.make_s2d_stem(folded, spec)
        np.testing.assert_array_equal(_hwio(got["wa"]), np.asarray(want["wa"]))
        np.testing.assert_array_equal(_hwio(got["wb"]), np.asarray(want["wb"]))
        for k in ("ba", "bb"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    ref_spec, spec, _, ref_folded, folded, _ = stem8
    ref_qp = jax_darknet.quantize_folded_int8_full(ref_folded, ref_spec)
    want = jax_darknet.make_s2d_stem_int8(ref_folded, ref_qp, ref_spec)
    got = darknet.make_s2d_stem_int8(folded, darknet.quantize_folded_int8_full(folded, spec),
                                     spec)
    assert got["wbq"].dtype == torch.int8
    np.testing.assert_array_equal(_hwio(got["wbq"]), np.asarray(want["wbq"]))
    np.testing.assert_array_equal(_hwio(got["wa"]), np.asarray(want["wa"]))
    for k in ("wbs", "bb", "ba"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_s2d_down_selection_and_weights_bitexact(down):
    ref_spec, spec, _, ref_folded, folded, _ = down
    want = jax_darknet.make_s2d_down_int8(
        jax_darknet.quantize_folded_int8_full(ref_folded, ref_spec), ref_spec)
    got = darknet.make_s2d_down_int8(darknet.quantize_folded_int8_full(folded, spec), spec)
    assert set(got) == set(want) == {2}
    assert got[2].dtype == torch.int8 and tuple(got[2].shape) == (32, 64, 2, 2)
    np.testing.assert_array_equal(_hwio(got[2]), np.asarray(want[2]))


def test_stem_rejects_other_stem_shapes():
    """A 1x1 conv 1 is not the YOLOv3 stem: both packages refuse it."""
    def build(gs):
        b = gs._Builder(gs.NetInfo(width=64, height=64))
        b.conv(8, 3)
        b.conv(16, 1)
        b.conv(3 * (5 + 2), 1, bn=False, act="linear")
        b.yolo(gs.YOLOV3_MASKS[0], 2)
        return gs._finish(b.net, b.layers, b.out_channels)

    with pytest.raises(ValueError, match="stem shape"):
        jax_darknet.make_s2d_stem({}, build(jax_graphspec))
    with pytest.raises(ValueError, match="stem shape"):
        darknet.make_s2d_stem({}, build(port_graphspec))
    assert not darknet.s2d_train_stem_qualifies(build(port_graphspec))


@pytest.mark.parametrize("fixture", ["mini", "stem8"])
def test_stem_forward_matches_jax_f32(fixture, request):
    ref_spec, spec, _, ref_folded, folded, x = request.getfixturevalue(fixture)
    want = jax.jit(jax_darknet.s2d_stem_forward, static_argnums=2)(
        jax_darknet.make_s2d_stem(ref_folded, ref_spec), jnp.asarray(x), jnp.float32)
    got = darknet.s2d_stem_forward(darknet.make_s2d_stem(folded, spec), torch.from_numpy(x),
                                   torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_apply_folded_s2d_matches_jax_and_plain_f32(mini):
    ref_spec, spec, _, ref_folded, folded, x = mini
    want = jax.jit(lambda f, s, v: jax_darknet.apply_folded(
        f, ref_spec, v, compute_dtype=jnp.float32, s2d_stem=s))(
        ref_folded, jax_darknet.make_s2d_stem(ref_folded, ref_spec), jnp.asarray(x))
    xt = torch.from_numpy(x)
    got = darknet.apply_folded(folded, spec, xt, compute_dtype=torch.float32,
                               s2d_stem=darknet.make_s2d_stem(folded, spec))
    plain = darknet.apply_folded(folded, spec, xt, compute_dtype=torch.float32)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_bf16_s2d_runs_every_residual_unit_through_the_block(mini):
    """The bf16 path with packs hands every unit to the block function (K2
    on the card), the first one straight from the s2d stem's output."""
    _, spec, _, _, folded, x = mini
    packs = darknet.pack_residual_blocks(folded, spec)
    calls = []

    def block(xin, *pack):
        calls.append(tuple(xin.shape))
        return fused_residual_block_plain(xin, *pack)

    xt = torch.from_numpy(x)
    got = darknet.apply_folded(folded, spec, xt, packs=packs, block_fn=block,
                               s2d_stem=darknet.make_s2d_stem(folded, spec))
    assert len(calls) == len(packs) == 4 and calls[0] == (2, 32, 32, 8)
    plain = darknet.apply_folded(folded, spec, xt, packs=packs,
                                 block_fn=fused_residual_block_plain)
    for g, p in zip(got, plain):
        assert _rel(g.numpy(), p.numpy()) <= 5e-2


def _jax_stem_levels(ref_folded, qp, scales, ref_spec, x):
    """The int8 levels of the JAX stem's conv-0 and conv-1 outputs,
    computed with its primitives as ``apply_folded_int8_full`` does,
    compiled with the scales closed over."""
    st = jax_darknet.make_s2d_stem_int8(ref_folded, qp, ref_spec)

    def quant(y, s):
        return jnp.clip(jnp.round(y / s), -127, 127).astype(jnp.int8)

    def levels(x):
        a = jax_darknet._conv(jax_darknet._space_to_depth(x.astype(jnp.float32)),
                              st["wa"].astype(jnp.float32), 1, 1)
        aq = quant(jax_darknet._leaky(a + st["ba"]), scales["0"])
        y = jax_darknet._conv_b(aq, st["wbq"], preferred=jnp.bfloat16).astype(jnp.float32) \
            * (scales["0"] * st["wbs"]) + st["bb"]
        return aq, quant(jax_darknet._leaky(y), scales["1"])

    return [np.asarray(v) for v in jit_compiled(levels, jnp.asarray(x))]


def test_int8_full_s2d_matches_jax(stem8, monkeypatch):
    ref_spec, spec, _, ref_folded, folded, x = stem8
    qp = jax_darknet.quantize_folded_int8_full(ref_folded, ref_spec)
    scales = jax_darknet.calibrate_act_scales_full(ref_folded, ref_spec, jnp.asarray(x))
    stem = jax_darknet.make_s2d_stem_int8(ref_folded, qp, ref_spec)
    want = jit_compiled(lambda f, v: jax_darknet.apply_folded_int8_full(
        f, qp, scales, ref_spec, v, compute_dtype=jnp.float32, s2d_stem=stem),
        ref_folded, jnp.asarray(x))
    pqp = darknet.quantize_folded_int8_full(folded, spec)
    quantized = []
    quant = darknet.q8.quant
    monkeypatch.setattr(darknet.q8, "quant", lambda y, s: quantized.append(quant(y, s))
                        or quantized[-1])
    got = darknet.apply_folded_int8_full(folded, pqp, scales, spec, torch.from_numpy(x),
                                         compute_dtype=torch.float32,
                                         s2d_stem=darknet.make_s2d_stem_int8(folded, pqp, spec))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < INT8_TOL
    flips = [int((q.numpy() != r).sum()) for q, r in
             zip(quantized[:2], _jax_stem_levels(ref_folded, qp, scales, ref_spec, x))]
    n = quantized[0].numel() + quantized[1].numel()
    assert sum(flips) <= 1e-3 * n, f"int8 levels of the stem that flipped: {flips} of {n}"


def test_int8_full_s2d_close_to_plain_stem(stem8):
    _, spec, _, ref_folded, folded, x = stem8
    scales = jax_darknet.calibrate_act_scales_full(
        ref_folded, stem8[0], jnp.asarray(x))
    qp = darknet.quantize_folded_int8_full(folded, spec)
    xt = torch.from_numpy(x)
    plain = darknet.apply_folded_int8_full(folded, qp, scales, spec, xt,
                                           compute_dtype=torch.float32)
    got = darknet.apply_folded_int8_full(folded, qp, scales, spec, xt,
                                         compute_dtype=torch.float32,
                                         s2d_stem=darknet.make_s2d_stem_int8(folded, qp, spec))
    for g, p in zip(got, plain):
        assert _rel(g.numpy(), p.numpy()) < INT8_TOL


@pytest.mark.parametrize("int32_accum_max_hw", [0, 10 ** 6])
def test_s2d_down_against_plain_and_jax(down, int32_accum_max_hw):
    """Under int32 accumulation the relabelled conv's sums are exact, so the
    whole forward is bit-identical to the plain conv's; under bf16 rounding
    within 0.02 of the map (``tests/test_s2d_stem.py:210-240``)."""
    ref_spec, spec, _, ref_folded, folded, x = down
    ref_qp = jax_darknet.quantize_folded_int8_full(ref_folded, ref_spec)
    scales = jax_darknet.calibrate_act_scales_full(ref_folded, ref_spec, jnp.asarray(x))
    downs = jax_darknet.make_s2d_down_int8(ref_qp, ref_spec)
    want = jit_compiled(lambda f, v: jax_darknet.apply_folded_int8_full(
        f, ref_qp, scales, ref_spec, v, compute_dtype=jnp.float32, s2d_downs=downs,
        int32_accum_max_hw=int32_accum_max_hw), ref_folded, jnp.asarray(x))
    qp = darknet.quantize_folded_int8_full(folded, spec)
    xt = torch.from_numpy(x)
    kw = dict(compute_dtype=torch.float32, int32_accum_max_hw=int32_accum_max_hw)
    plain = darknet.apply_folded_int8_full(folded, qp, scales, spec, xt, **kw)
    got = darknet.apply_folded_int8_full(folded, qp, scales, spec, xt,
                                         s2d_downs=darknet.make_s2d_down_int8(qp, spec), **kw)
    for g, p, w in zip(got, plain, want):
        if int32_accum_max_hw:
            np.testing.assert_array_equal(g.numpy(), p.numpy())
        else:
            assert _rel(g.numpy(), p.numpy()) < INT8_TOL
        assert _rel(g.numpy(), w) <= HEAD_RTOL


DET = dict(model_size=64, tile_size=64, host_resize=True, conf_thres=0.05, nms_thres=0.4)


def test_detector_s2d_matches_jax_f32(mini):
    ref_spec, spec, params, *_ = mini
    tiles = np.random.RandomState(0).randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    ref = JaxDetector(ref_spec, params, compute_dtype=jnp.float32, s2d_stem=True, **DET)
    d0, v0 = (np.asarray(a) for a in ref(tiles))
    det = Detector(spec, params_from_jax(params, spec), compute_dtype=torch.float32,
                   s2d_stem=True, device="cpu", **DET)
    d1, v1 = (a.numpy() for a in det(tiles))
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_allclose(d1[v1], d0[v0], rtol=1e-3, atol=1e-3)
    # and on a mesh of two CPU entries: the stem copied to both
    meshed = Detector(spec, params_from_jax(params, spec), compute_dtype=torch.float32,
                      s2d_stem=True, mesh=make_mesh(devices=["cpu", "cpu"]), **DET)
    assert all(r.s2d is not None for r in meshed._replicas)
    d2, v2 = (a.numpy() for a in meshed(tiles))
    np.testing.assert_array_equal(v2, v1)
    np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-5)


def test_detector_int8_full_s2d_stem_and_downsample(down, tmp_path):
    """``int8_full`` with the s2d stem and downsample, calibrated by JAX and
    read through the sidecar: head maps within 0.02 of JAX's."""
    ref_spec, spec, params, *_ = down
    tiles = np.random.RandomState(4).randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    kw = dict(precision="int8_full", s2d_stem=True, s2d_downsample=True,
              compute_dtype=jnp.float32, **DET)
    ref = JaxDetector(ref_spec, params, **kw)
    ref.calibrate(tiles)
    want = jit_compiled(lambda f, v: jax_darknet.apply_folded_int8_full(
        f, ref._qparams, ref._act_scales, ref_spec, v, compute_dtype=jnp.float32,
        s2d_stem=ref._s2d_params, s2d_downs=ref._s2d_downs),
        ref.params, jnp.asarray(tiles, jnp.float32) * np.float32(1 / 255))
    det = Detector(spec, params_from_jax(params, spec), device="cpu",
                   **{**kw, "compute_dtype": torch.float32})
    det.load_calibration(ref.save_calibration(str(tmp_path / "scales.json")))
    assert set(det._replicas[0].s2d_downs) == {2}
    got = det.head_maps(torch.from_numpy(tiles))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < INT8_TOL
    dets, valid = det(tiles)
    assert torch.isfinite(dets).all() and tuple(valid.shape) == (2, 64)


CASES = [dict(precision="int8_early", s2d_stem=True),
         dict(fold_bn=False, s2d_stem=True),
         dict(s2d_downsample=True),
         dict(s2d_stem=True, s2d_downsample=True),
         dict(precision="int8_full", s2d_downsample=True),
         dict(pallas_blocks=True, precision="int8_full"),
         dict(pallas_blocks=True, fold_bn=False),
         dict(precision="int8_full", s2d_stem=True),  # mini conv 1 is not quantized
         dict(pallas_blocks=True),
         dict(s2d_stem=True)]


@pytest.mark.parametrize("kwargs", CASES, ids=[",".join(f"{k}={v}" for k, v in c.items())
                                               for c in CASES])
def test_detector_raises_where_jax_raises(mini, kwargs):
    ref_spec, spec, params, *_ = mini

    def raises(make):
        try:
            make()
        except ValueError as e:
            return str(e)
        return None

    want = raises(lambda: JaxDetector(ref_spec, params, **kwargs))
    got = raises(lambda: Detector(spec, params_from_jax(params, spec), device="cpu", **kwargs))
    assert (got is None) == (want is None), (got, want)
    if want is not None:
        assert got == want
    else:
        det = Detector(spec, params_from_jax(params, spec), device="cpu", **kwargs)
        assert det.s2d_stem == bool(kwargs.get("s2d_stem"))
        assert det.pallas_blocks == bool(kwargs.get("pallas_blocks"))
