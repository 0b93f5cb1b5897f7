"""YOLOv4 on the port: the graph (Mish, CSP units, SPP, PANet,
grid-sensitive heads), the forward paths and the decode against the plain
YOLOv4 reference of the benchmark (``benchmark/reference/yolov4.py``; the
JAX package has no Mish), the bias-and-Mish epilogue, and the paths that
refuse YOLOv4's parts.

Tests marked ``card`` need a CUDA card and skip without one; they hold the
kernel to its plain version to one bf16 ulp.  Run them on the card without
the JAX conftest:
``python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_yolov4.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amyloid_yolo_tpu_torch.graphspec import (ConvSpec, RouteSpec, ShortcutSpec, YoloSpec,
                                              emit_cfg, from_cfg, yolov3_spec)
from amyloid_yolo_tpu_torch.kernels.bias_leaky import bias_mish, bias_mish_plain
from amyloid_yolo_tpu_torch.models import darknet, heads
from amyloid_yolo_tpu_torch.parallel.spatial import layer_strides
from benchmark.harness import flops, traffic, weights
from benchmark.reference import yolov4 as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V4_CFG = os.path.join(ROOT, "benchmark", "configs", "yolov4-amyloid-608.cfg")
MINI_CFG = os.path.join(ROOT, "benchmark", "tests", "mini_v4.cfg")
ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146), (142, 110),
           (192, 243), (459, 401))


def _mish_convs(spec):
    return [l for l in spec.layers if isinstance(l, ConvSpec) and l.activation == "mish"]


# ---------------------------------------------------------------------------
# the graph


def test_the_frozen_cfg_is_yolov4():
    spec = from_cfg(V4_CFG)
    convs = [l for l in spec.layers if isinstance(l, ConvSpec)]
    assert len(spec.layers) == 162 and len(convs) == 110 and len(_mish_convs(spec)) == 72
    # the 23 CSP residual units: a shortcut over a 1x1 and a 3x3 Mish conv
    units = [l for l in spec.layers if isinstance(l, ShortcutSpec)]
    assert len(units) == 23
    assert all(spec.layers[u.index - 1].activation == "mish"
               and spec.layers[u.index - 1].kernel == 3 for u in units)
    # 22 of them keep the width in the 1x1, the first halves it
    mids = [(spec.layers[u.index - 2].out_ch, spec.layers[u.index - 1].out_ch) for u in units]
    assert sum(m == c for m, c in mids) == 22 and mids[0] == (32, 64)
    assert darknet.fusible_residual_blocks(spec) == {}
    # SPP: max-pools of 5, 9, 13 at 19², joined with their input to 2048 channels
    spp = [l for l in spec.layers if isinstance(l, RouteSpec) and len(l.layers) == 4]
    assert len(spp) == 1 and spec.out_channels[spp[0].index] == 2048
    assert [spec.layers[i].kernel for i in spp[0].layers[:3]] == [13, 9, 5]
    strides = layer_strides(spec)
    assert 608 // strides[spp[0].index] == 19
    # PANet's routes to the backbone's stride-8 and stride-16 outputs
    assert {s for l in spec.layers if isinstance(l, RouteSpec) for s in l.layers} >= {54, 85}
    # the heads: strides 8, 16, 32 in order, the published masks, anchors and scale_x_y
    yolos = [l for l in spec.layers if isinstance(l, YoloSpec)]
    assert [strides[y.index] for y in yolos] == [8, 16, 32]
    assert [y.anchors for y in yolos] == [ANCHORS[0:3], ANCHORS[3:6], ANCHORS[6:9]]
    assert [y.scale_x_y for y in yolos] == [1.2, 1.1, 1.05]
    assert all(y.num_classes == 2 and spec.out_channels[y.index] == 21 for y in yolos)
    # the reference reads the same graph
    _, layers = ref.layers(V4_CFG)
    assert [l["cout"] for l in layers] == list(spec.out_channels)
    assert sum(l.get("act") == "mish" for l in layers) == 72


@pytest.mark.parametrize("size,walked,darknet_bflops", [(608, 128.39, 128.5), (416, 60.10, 60.1)])
def test_conv_flops_at_80_classes_are_darknets(tmp_path, size, walked, darknet_bflops):
    text = open(V4_CFG).read().replace("classes=2", "classes=80").replace("filters=21",
                                                                          "filters=255")
    path = tmp_path / "yolov4-80.cfg"
    path.write_text(text)
    _, layers = ref.layers(str(path))
    g = flops.conv_flops(layers, size) / 1e9
    assert g == pytest.approx(walked, abs=0.005)
    assert abs(g / darknet_bflops - 1) < 0.002   # the darknet README's BFLOPs


def test_emit_cfg_round_trips_activation_and_scale_x_y(tmp_path):
    spec = from_cfg(MINI_CFG)
    path = tmp_path / "again.cfg"
    path.write_text(emit_cfg(spec))
    again = from_cfg(str(path))
    assert again.layers == spec.layers and again.out_channels == spec.out_channels
    assert len(_mish_convs(again)) == 9
    assert [l.scale_x_y for l in again.layers if isinstance(l, YoloSpec)] == [1.2, 1.05]


def test_an_unknown_activation_raises(tmp_path):
    path = tmp_path / "swish.cfg"
    path.write_text(open(MINI_CFG).read().replace("activation=mish", "activation=swish", 1))
    with pytest.raises(ValueError, match="layer 0: unsupported activation 'swish'"):
        from_cfg(str(path))


def test_the_refusal_names_what_of_yolov4_a_graph_holds():
    darknet.refuse_grid_sensitive(yolov3_spec(num_classes=2), "a path")
    with pytest.raises(ValueError, match=r"a path takes YOLOv3's leaky convs and heads only; "
                       r"this graph has 72 Mish convs \(first 0\); yolo layers with "
                       r"scale_x_y != 1: 139 \(1.2\), 150 \(1.1\), 161 \(1.05\)"):
        darknet.refuse_grid_sensitive(from_cfg(V4_CFG), "a path")


# ---------------------------------------------------------------------------
# the forward and the decode against the reference, on the mini YOLOv4


def _mini(seed=11, n=3, size=64):
    """The mini graph, reference-scheme weights with the heads scaled and
    the objectness raised as the benchmark makes them, and a batch."""
    _, layers = ref.layers(MINI_CFG)
    sd = weights.reference_scheme(layers, traffic.generator(seed, "weights", "cpu"), "cpu")
    # convs at He's scale, so that activations stay near 1 and Mish is not
    # the line 0.6·x it is near 0 (the benchmark's N(0, 0.02) leaves them
    # tiny); BN statistics and shifts that are not the identity, so that
    # folding them matters
    g = torch.Generator().manual_seed(seed)
    for k in list(sd):
        if k.endswith(".weight") and sd[k].dim() == 4:
            sd[k] = torch.randn(sd[k].shape, generator=g) * (2.0 / sd[k][0].numel()) ** 0.5
        elif k.endswith("running_mean") or k.endswith(".bias"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=g)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(sd[k].shape, generator=g)
    x = torch.rand(n, 3, size, size, generator=g)
    from benchmark.harness.kind_detect_v4 import scale_heads
    hm = scale_heads(sd, layers, x, 0.5)
    weights.objectness_shift(sd, layers, hm, 0.05, 0.8)
    with torch.no_grad():
        want = [h.permute(0, 2, 3, 1) for h in ref.forward(sd, layers, x)]
    return from_cfg(MINI_CFG), layers, sd, x.permute(0, 2, 3, 1).contiguous(), want


@pytest.mark.parametrize("path", ["apply", "apply_folded"])
def test_f32_forwards_match_the_reference(path):
    spec, _, sd, x, want = _mini()
    with torch.no_grad():
        if path == "apply":
            got = darknet.apply(sd, spec, x, compute_dtype=torch.float32)
        else:
            got = darknet.apply_folded(darknet.fold_batchnorm(sd, spec), spec, x,
                                       compute_dtype=torch.float32)
    # float32 rounding through 26 convs: the maps spread by 0.5
    assert all(torch.allclose(g, w, rtol=0, atol=2e-5) for g, w in zip(got, want))


def test_bf16_folded_forward_matches_the_reference_to_bf16():
    spec, _, sd, x, want = _mini()
    with torch.no_grad():
        got = darknet.apply_folded(darknet.fold_batchnorm(sd, spec), spec, x,
                                   compute_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        err = (g - w).abs()
        # bf16 keeps 8 bits: each of the 26 convs and epilogues rounds its
        # output by up to 2⁻⁹ relative, and the maps reach 3.5, where a bf16
        # step is 2⁻⁶; the roundings compound to a few steps (0.096 and
        # 0.0096 read here)
        assert err.max() < 0.2 and err.mean() < 0.02
    # Mish taken as linear is far off
    linear = dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(l, activation="linear") if l in _mish_convs(spec) else l
        for l in spec.layers))
    with torch.no_grad():
        wrong = darknet.apply_folded(darknet.fold_batchnorm(sd, linear), linear, x,
                                     compute_dtype=torch.bfloat16)
    assert max((g - w).abs().max() for g, w in zip(wrong, want)) > 10.0


def test_decode_all_matches_the_reference_decode():
    spec, layers, _, _, want = _mini()
    yolos = [l for l in layers if l["type"] == "yolo"]
    got = heads.decode_all(want, spec, 64)
    rows = torch.cat([ref.decode(w.permute(0, 3, 1, 2).contiguous(), y["anchors"], 64,
                                 y["classes"], y["scale_x_y"])
                      for w, y in zip(want, yolos)], dim=1)
    assert torch.allclose(got, rows, rtol=1e-6, atol=1e-5)
    # without scale_x_y the centres move by up to (s - 1)/2 of a cell
    plain = dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(l, scale_x_y=1.0) if isinstance(l, YoloSpec) else l
        for l in spec.layers))
    moved = (heads.decode_all(want, plain, 64)[..., :2] - rows[..., :2]).abs().max()
    assert moved > 0.05


def test_decode_topk_decodes_the_selected_rows_as_the_reference():
    spec, layers, _, _, want = _mini()
    yolos = [l for l in layers if l["type"] == "yolo"]
    rows = torch.cat([ref.decode(w.permute(0, 3, 1, 2).contiguous(), y["anchors"], 64,
                                 y["classes"], y["scale_x_y"])
                      for w, y in zip(want, yolos)], dim=1)
    det, scores, n_cand = heads.decode_topk(want, spec, 64, 0.8, 16)
    passing = rows[..., 4] >= 0.8
    assert n_cand.tolist() == passing.sum(dim=1).tolist() and int(n_cand.sum()) > 0
    for b in range(rows.shape[0]):
        k = int(min(n_cand[b], 16))
        # each selected row is a passing reference row, box for box
        r = rows[b, passing[b]]
        xyxy = torch.cat([r[:, :2] - r[:, 2:4] / 2, r[:, :2] + r[:, 2:4] / 2], dim=1)
        for d in det[b, :k]:
            gap = (xyxy - d[:4]).abs().max(dim=1).values
            assert gap.min() < 1e-4


def test_grid_sensitive_is_nothing_at_one():
    xy = torch.rand(4, 2)
    assert heads.grid_sensitive(xy, 1.0) is xy
    assert torch.allclose(heads.grid_sensitive(xy, 1.2), xy * 1.2 - 0.1)


# ---------------------------------------------------------------------------
# the epilogue's plain version


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_bias_mish_plain_is_mish_of_the_rounded_sum(dtype, layout):
    g = torch.Generator().manual_seed(2)
    x = (4 * torch.randn(2, 21, 5, 7, generator=g)).to(dtype)
    x[0, 0, 0, :6] = torch.tensor([-0.0, 25.0, -30.0, float("inf"), float("-inf"), 20.0])
    b = torch.randn(21, generator=g).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    got = bias_mish_plain(x, b)
    t = x + b[None, :, None, None]          # the sum in x's dtype
    want = F.mish(t.float()).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    # x·tanh(softplus(x)) as the reference writes it, to float32 rounding
    ref_f32 = ref.mish(t.float()).to(dtype)
    fin = torch.isfinite(ref_f32)
    assert torch.allclose(got[fin].float(), ref_f32[fin].float(), rtol=1e-2, atol=0)
    # above 20 mish is its input; the CPU wrapper is the plain version
    assert got[0, 0, 0, 1].item() == float(t[0, 0, 0, 1])
    assert torch.equal(torch.nan_to_num(bias_mish(x, b)), torch.nan_to_num(got))


def test_a_folded_mish_conv_on_the_cpu_launches_nothing():
    spec = from_cfg(MINI_CFG)
    layer = spec.layers[0]
    g = torch.Generator().manual_seed(1)
    folded = {"conv_0": {"w": 0.1 * torch.randn(8, 3, 3, 3, generator=g),
                         "b": torch.randn(8, generator=g)}}
    x = torch.randn(2, 3, 9, 9, generator=g).to(torch.bfloat16)
    before = bias_mish.launches
    y = darknet.folded_conv(folded, 0, layer, x, torch.bfloat16)
    assert bias_mish.launches == before
    out = darknet.conv(folded["conv_0"]["w"], layer, x, torch.bfloat16)
    assert torch.equal(y, bias_mish_plain(out, folded["conv_0"]["b"]))
    # the unfolded path's activation rounds the same way
    assert torch.equal(darknet.activate(layer, out + folded["conv_0"]["b"].to(
        torch.bfloat16)[None, :, None, None]), y)


# ---------------------------------------------------------------------------
# the paths built for YOLOv3 alone refuse YOLOv4's parts


@pytest.mark.parametrize("precision", ["int8_early", "int8_full"])
def test_the_int8_detectors_refuse_yolov4(precision):
    from amyloid_yolo_tpu_torch.detectors import Detector
    with pytest.raises(ValueError, match=f"{precision} takes YOLOv3's leaky convs"):
        Detector(from_cfg(MINI_CFG), device="cpu", precision=precision, model_size=64)


def test_the_int8_calibrators_refuse_yolov4():
    spec = from_cfg(MINI_CFG)
    folded = darknet.fold_batchnorm(darknet.init_params(torch.Generator().manual_seed(0), spec),
                                    spec)
    x = torch.rand(1, 64, 64, 3)
    with pytest.raises(ValueError, match="int8_full takes"):
        darknet.calibrate_act_scales_full(folded, spec, x)
    with pytest.raises(ValueError, match="int8_early takes"):
        darknet.calibrate_act_scales(folded, spec, x, 2)


def test_the_s2d_stem_refuses_yolov4():
    from amyloid_yolo_tpu_torch.detectors import Detector
    with pytest.raises(ValueError, match="the s2d stem takes YOLOv3's"):
        Detector(from_cfg(MINI_CFG), device="cpu", s2d_stem=True, model_size=64)
    assert not darknet.s2d_train_stem_qualifies(from_cfg(MINI_CFG))


@pytest.mark.parametrize("part", ["mish", "scale_x_y"])
def test_the_trainer_refuses_yolov4(part):
    from amyloid_yolo_tpu_torch.training import Trainer, TrainConfig
    spec = yolov3_spec(num_classes=2)
    if part == "mish":
        layers = tuple(dataclasses.replace(l, activation="mish") if l.index == 0 else l
                       for l in spec.layers)
    else:
        layers = tuple(dataclasses.replace(l, scale_x_y=1.1) if isinstance(l, YoloSpec) else l
                       for l in spec.layers)
    with pytest.raises(ValueError, match="the Trainer takes YOLOv3's"):
        Trainer(TrainConfig(data_config="unused.data"), spec=dataclasses.replace(
            spec, layers=layers), device="cpu")


def test_the_f32_detector_runs_yolov4_on_the_cpu():
    from amyloid_yolo_tpu_torch.detectors import Detector
    spec, _, sd, x, want = _mini(n=2)
    det = Detector(spec, params=sd, device="cpu", compute_dtype=torch.float32,
                   model_size=64, tile_size=64)
    tiles = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    dets, valid = det(tiles)
    assert dets.shape == (2, 64, 7) and valid.dtype == torch.bool


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def mish_shapes(spec, side: int):
    """``(C, H)`` of every Mish conv's output at a ``side``² input."""
    strides = layer_strides(spec)
    return [(l.out_ch, side // strides[l.index]) for l in _mish_convs(spec)]


def test_the_mish_shapes_of_yolov4():
    shapes = mish_shapes(from_cfg(V4_CFG), 608)
    assert len(shapes) == 72 and shapes[0] == (32, 608)
    # 94.8 M elements an image: 24.27 GB read and written at B=64 in bf16
    n = sum(c * h * h for c, h in shapes)
    assert n == 94_818_816 and 4 * 64 * n / 1e9 == pytest.approx(24.27, abs=0.01)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The distance in bf16 steps (bits of the sign-magnitude order)."""
    def order(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(got.cpu()) - order(want.cpu())).abs()


@pytest.mark.card
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_kernel_is_within_one_ulp_on_the_mish_shapes(cuda, layout):
    gen = torch.Generator(device=cuda).manual_seed(9)
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    differ = total = 0
    for c, h in mish_shapes(from_cfg(V4_CFG), 608):
        x = (3 * torch.randn(2, c, h, h, device=cuda, generator=gen)).to(
            torch.bfloat16).contiguous(memory_format=fmt)
        b = torch.randn(c, device=cuda, generator=gen).to(torch.bfloat16)
        want = bias_mish_plain(x, b)
        before = bias_mish.launches
        got = bias_mish(x, b)
        torch.cuda.synchronize()
        assert got.data_ptr() == x.data_ptr() and bias_mish.launches == before + 1
        d = _ulps(got, want)
        assert int(d.max()) <= 1, (c, h, layout)
        differ += int((d > 0).sum())
        total += d.numel()
    print(f"bias_mish {layout}: {differ} of {total} elements differ by one bf16 ulp "
          f"({100.0 * differ / total:.4f}%)")


@pytest.mark.card
def test_kernel_in_float32_and_on_special_values(cuda):
    x = torch.tensor([-0.0, 0.0, 20.0, 20.5, -20.0, -90.0, float("inf"), float("-inf"),
                      float("nan"), 1e-30], device=cuda).view(1, 10, 1, 1)
    b = torch.zeros(10, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        xs, bs = x.to(dtype), b.to(dtype)
        want = bias_mish_plain(xs.clone(), bs)
        got = bias_mish(xs.clone(), bs)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        fin = ~torch.isnan(want)
        assert torch.allclose(got[fin].float(), want[fin].float(), rtol=2e-6 if
                              dtype == torch.float32 else 8e-3, atol=0)


@pytest.mark.card
def test_a_misaligned_view_takes_the_scalar_path(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(3, 21, 13, 13, device=cuda, generator=gen).to(torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    b = torch.randn(21, device=cuda, generator=gen).to(torch.bfloat16)
    want = bias_mish_plain(view, b)
    got = bias_mish(view, b)
    torch.cuda.synchronize()
    assert int(_ulps(got, want).max()) <= 1


@pytest.mark.card
def test_a_yolov4_detector_call_runs_72_mish_epilogues(cuda):
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.kernels.bias_leaky import bias_leaky
    det = Detector(from_cfg(V4_CFG), device=cuda, model_size=608)
    rng = np.random.RandomState(0)
    tiles = torch.from_numpy(rng.randint(0, 256, (2, 1536, 1536, 3)).astype(np.uint8)).to(cuda)
    with torch.inference_mode():
        m0, l0 = bias_mish.launches, bias_leaky.launches
        maps = det.head_maps(tiles)
        torch.cuda.synchronize()
    assert bias_mish.launches - m0 == 72 and bias_leaky.launches - l0 == 38
    assert [tuple(m.shape) for m in maps] == [(2, 76, 76, 21), (2, 38, 38, 21), (2, 19, 19, 21)]
