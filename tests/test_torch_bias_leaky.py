"""The library convs' epilogue (``kernels/bias_leaky.py``): bias and leaky
ReLU in one pass.

On the CPU: the plain version is the folded forward's expression, and both
agree with the rounding points the kernel implements (an independent numpy
model of them), on values that include ``-0.0``, infinities, NaN and bf16
rounding ties; the folded conv on the CPU launches nothing.

Tests marked ``card`` need a CUDA card and skip without one.  They hold the
kernel to the plain version bit for bit (NaN by mask) and import nothing
of JAX; run them on the card without the JAX conftest:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bias_leaky.py``.
"""

import numpy as np
import pytest
import torch

from amyloid_yolo_tpu_torch.graphspec import ConvSpec, yolov3_spec
from amyloid_yolo_tpu_torch.kernels.bias_leaky import bias_leaky, bias_leaky_plain
from amyloid_yolo_tpu_torch.kernels.conv_block import LEAKY_SLOPE
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.parallel.spatial import layer_strides

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
LAYOUTS = ("channels_last", "nchw")


def _layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    return x.contiguous(memory_format=fmt)


def _special_map(dtype, layout, gen, b=2, c=21, h=5, w=7, device="cpu"):
    """A conv-output-like NCHW map and a bias: normal values; in channel 2
    (bias -0.0) -0.0, +0.0, ±inf, NaN and ±1e-30; in bf16, in channels 0
    and 1 (biases 2⁻⁸ and -2⁻⁸), sums that fall exactly halfway between
    two bf16 values, so that they round to even both ways."""
    x = torch.randn(b, c, h, w, generator=gen).to(dtype)
    bias = (0.5 * torch.randn(c, generator=gen)).to(dtype)
    x[0, 2, 0, :7] = torch.tensor([-0.0, 0.0, float("inf"), float("-inf"), float("nan"),
                                   -1e-30, 1e-30], dtype=dtype)
    bias[2] = -0.0
    if dtype == torch.bfloat16:
        bias[0], bias[1] = 2.0 ** -8, -2.0 ** -8
        ties = torch.tensor([1.0, 1.0 + 2.0 ** -7, -1.0, -(1.0 + 2.0 ** -7)], dtype=dtype)
        x[0, 0, 0, :4] = ties
        x[0, 1, 0, :4] = ties
    return _layout(x, layout).to(device), bias.to(device)


def _round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 → the nearest bf16 (ties to even), as float32; NaN stays NaN."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    out = rounded.view(np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), out)


def _reference(x: torch.Tensor, b: torch.Tensor, leaky: bool) -> np.ndarray:
    """The kernel's arithmetic in numpy float32: t = round(v + b);
    y = t >= 0 ? t : round(t · round(0.1))."""
    rnd = _round_bf16 if x.dtype == torch.bfloat16 else (lambda a: a.astype(np.float32))
    v = x.float().numpy()
    bb = b.float().numpy()[None, :, None, None]
    with np.errstate(invalid="ignore", over="ignore"):
        t = rnd(v + bb)
        if not leaky:
            return t
        slope = np.float32(rnd(np.array([LEAKY_SLOPE], np.float32))[0])
        return np.where(t >= 0, t, rnd(t * slope))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype and shape, NaN at the same places, every other value
    equal bit for bit (signs of zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.float().cpu(), b.float().cpu()
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_is_the_folded_forwards_expression(dtype, leaky, layout):
    gen = torch.Generator().manual_seed(7)
    x, b = _special_map(DTYPES[dtype], layout, gen)
    layer = ConvSpec(index=0, in_ch=3, out_ch=x.shape[1], kernel=1, stride=1,
                     batch_normalize=True, activation="leaky" if leaky else "linear")
    today = darknet.activate(layer, x + b.to(x.dtype)[None, :, None, None])
    got = bias_leaky_plain(x, b, leaky)
    assert torch.equal(torch.isnan(got), torch.isnan(today))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(today))
    assert torch.equal(torch.signbit(got), torch.signbit(today))
    assert _same(got, torch.from_numpy(_reference(x, b, leaky)).to(got.dtype))
    # the CPU wrapper is the plain version, out left as it was
    before = x.clone()
    assert _same(bias_leaky(x, b, leaky), got) and _same(x, before)


def test_plain_rounds_the_ties_to_even_and_keeps_negative_zero():
    gen = torch.Generator().manual_seed(3)
    x, b = _special_map(torch.bfloat16, "nchw", gen)
    y = bias_leaky_plain(x, b, True).float()
    s = torch.tensor(LEAKY_SLOPE, dtype=torch.bfloat16).item()
    # 1 + 2⁻⁸ → 1 and 1 + 2⁻⁷ + 2⁻⁸ → 1 + 2⁻⁶ (ties to even); 1 - 2⁻⁸ is exact
    assert y[0, 0, 0, :2].tolist() == [1.0, 1.0 + 2.0 ** -6]
    assert y[0, 1, 0, :2].tolist() == [1.0 - 2.0 ** -8, 1.0]
    # -(1 + 2⁻⁷) + 2⁻⁸ → -1 (a tie), then the leaky's product
    want = torch.tensor([(-1.0 + 2.0 ** -8) * s, -1.0 * s], dtype=torch.bfloat16)
    assert y[0, 0, 0, 2:4].tolist() == want.float().tolist()
    # -0.0 + -0.0 stays -0.0 and is ">= 0"; +0.0 + -0.0 is +0.0
    assert torch.signbit(y[0, 2, 0, 0]) and not torch.signbit(y[0, 2, 0, 1])
    assert y[0, 2, 0, 2] == float("inf") and y[0, 2, 0, 3] == float("-inf")
    assert torch.isnan(y[0, 2, 0, 4])


def test_folded_conv_on_the_cpu_launches_nothing():
    gen = torch.Generator().manual_seed(1)
    layer = ConvSpec(index=0, in_ch=8, out_ch=16, kernel=3, stride=1,
                     batch_normalize=True, activation="leaky")
    folded = {"conv_0": {"w": 0.1 * torch.randn(16, 8, 3, 3, generator=gen),
                         "b": torch.randn(16, generator=gen)}}
    x = _layout(torch.randn(2, 8, 9, 9, generator=gen), "channels_last").to(torch.bfloat16)
    before = bias_leaky.launches
    y = darknet.folded_conv(folded, 0, layer, x, torch.bfloat16)
    assert bias_leaky.launches == before
    want = bias_leaky_plain(darknet.conv(folded["conv_0"]["w"], layer, x, torch.bfloat16),
                            folded["conv_0"]["b"], True)
    assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def epilogue_shapes(spec, side: int):
    """``(C, H, leaky)`` of every conv's output outside the fusible
    residual units at a ``side``² input: 29 in YOLOv3, 26 of them leaky."""
    inside = {j for i in darknet.fusible_residual_blocks(spec) for j in (i, i + 1)}
    strides = layer_strides(spec)
    return [(layer.out_ch, side // strides[i], layer.activation == "leaky")
            for i, layer in enumerate(spec.layers)
            if isinstance(layer, ConvSpec) and i not in inside]


def test_the_epilogue_shapes_of_yolov3():
    shapes = epilogue_shapes(yolov3_spec(num_classes=2), 416)
    assert len(shapes) == 29 and sum(leaky for _, _, leaky in shapes) == 26
    assert shapes[0] == (32, 416, True) and (21, 13, False) in shapes
    assert sum(c * h * h for c, h, _ in shapes) == 16_558_113


@pytest.mark.card
@pytest.mark.parametrize("side,batch", [(416, 1), (416, 64), (512, 2), (608, 2)])
def test_kernel_equals_plain_on_the_models_conv_shapes(cuda, side, batch):
    gen = torch.Generator(device=cuda).manual_seed(side + batch)
    checked = 0
    for c, h, leaky in epilogue_shapes(yolov3_spec(num_classes=2), side):
        for dtype in DTYPES.values():
            for layout in LAYOUTS:
                x = _layout(torch.randn(batch, c, h, h, device=cuda, generator=gen)
                            .to(dtype), layout)
                x[0, 0, 0, :5] = torch.tensor([-0.0, float("inf"), float("-inf"),
                                               float("nan"), 0.0], dtype=dtype, device=cuda)
                b = torch.randn(c, device=cuda, generator=gen).to(dtype)
                want = bias_leaky_plain(x, b, leaky)
                before = bias_leaky.launches
                got = bias_leaky(x, b, leaky)
                torch.cuda.synchronize()
                assert got.data_ptr() == x.data_ptr() and bias_leaky.launches == before + 1
                assert _same(got, want), (side, batch, c, h, leaky, dtype, layout)
                checked += 1
                del x, want, got
    assert checked == 29 * 4


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_misaligned_view_takes_the_scalar_path(cuda, dtype, layout):
    gen = torch.Generator().manual_seed(5)
    x, b = _special_map(DTYPES[dtype], layout, gen, b=3, c=21, h=13, w=13)
    shape = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    if layout == "nchw":
        view = buf[1:].view(shape)
    else:
        view = buf[1:].view(shape[0], shape[2], shape[3], shape[1]).permute(0, 3, 1, 2)
    view.copy_(x.to(cuda))
    assert view.data_ptr() % 16 != 0 and _layout(view, layout).data_ptr() == view.data_ptr()
    want = bias_leaky_plain(view, b.to(cuda), True)
    got = bias_leaky(view, b.to(cuda), True)
    torch.cuda.synchronize()
    assert _same(got, want)
    assert _same(got.cpu(), torch.from_numpy(_reference(x, b, True)).to(got.dtype))


@pytest.mark.card
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    b = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="bf16 or float32"):
        bias_leaky(torch.zeros(1, 8, 4, 4, dtype=torch.float16, device=cuda), b, True)
    with pytest.raises(ValueError, match="requires grad"):
        bias_leaky(torch.zeros(1, 8, 4, 4, device=cuda, requires_grad=True), b, True)
    with pytest.raises(ValueError, match="contiguous"):
        bias_leaky(torch.zeros(1, 8, 4, 8, device=cuda)[..., ::2], b, True)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\) and \(C,\)"):
        bias_leaky(torch.zeros(1, 8, 4, 4, device=cuda), torch.zeros(7, device=cuda), True)


@pytest.mark.card
def test_a_detector_call_runs_29_epilogues_bit_for_bit(cuda, monkeypatch):
    from amyloid_yolo_tpu_torch.detectors import Detector
    det = Detector(yolov3_spec(num_classes=2), device=cuda)
    rng = np.random.RandomState(0)
    tiles = torch.from_numpy(rng.randint(0, 256, (2, 1536, 1536, 3)).astype(np.uint8)).to(cuda)
    with torch.inference_mode():
        before = bias_leaky.launches
        maps = det.head_maps(tiles)
        torch.cuda.synchronize()
        assert bias_leaky.launches - before == 29
        monkeypatch.setattr(darknet, "bias_leaky", bias_leaky_plain)
        plain = det.head_maps(tiles)
    assert bias_leaky.launches - before == 29
    assert len(maps) == 3 and all(_same(m, p) for m, p in zip(maps, plain))
