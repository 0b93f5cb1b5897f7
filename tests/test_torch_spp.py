"""YOLOv4's SPP block in one pass (``kernels/spp_pool.py``): the matcher
that finds the block in a graph, the plain version, and the folded forward
through the block against the same forward layer by layer.

On the CPU the wrapper returns the plain version (``F.max_pool2d`` and
``torch.cat``) and launches nothing; on the card it launches the kernel on
every input it takes and raises on the others.  Tests marked ``card`` need a CUDA
card and skip without one: they hold the kernel to the plain version on
the card bit for bit.  Run them on the card without the JAX conftest:
``python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_spp.py``.
"""

import os
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amyloid_yolo_tpu_torch.graphspec import MaxPoolSpec, RouteSpec, from_cfg, yolov3_spec
from amyloid_yolo_tpu_torch.kernels.spp_pool import spp_pool, spp_pool_plain
from amyloid_yolo_tpu_torch.models import darknet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V4_CFG = os.path.join(ROOT, "benchmark", "configs", "yolov4-amyloid-608.cfg")
MINI_CFG = os.path.join(ROOT, "benchmark", "tests", "mini_v4.cfg")
V3_CFGS = [os.path.join(ROOT, "benchmark", "configs", f"yolov3-amyloid-{s}.cfg")
           for s in ("416", "512a")]
INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}

TINY_CFG = textwrap.dedent("""\
    [net]
    width=64
    height=64
    channels=3

    [convolutional]
    batch_normalize=1
    filters=8
    size=3
    stride=1
    pad=1
    activation=leaky

    [maxpool]
    size=2
    stride=2

    [convolutional]
    batch_normalize=1
    filters=16
    size=3
    stride=1
    pad=1
    activation=leaky

    [maxpool]
    size=2
    stride=1

    [route]
    layers=-2

    [maxpool]
    size=2
    stride=1

    [route]
    layers=-1,-3,-4

    [convolutional]
    size=1
    stride=1
    pad=1
    filters=21
    activation=linear

    [yolo]
    mask=0,1,2
    anchors=10,14, 23,27, 37,58
    classes=2
    num=3
    """)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(INT[t.dtype])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a.cpu()),
                                                                     _bits(b.cpu()))


def _with_spp(tmp_path, route: str, extra: str = "", pool2: str = "9"):
    """mini_v4.cfg with its SPP route's members given as ``route`` and
    ``extra`` appended after the block's route (a route to read a layer
    of the block from later on)."""
    text = open(MINI_CFG).read()
    old = "[route]\nlayers=-1,-3,-5,-6\n"
    assert text.count(old) == 1
    text = text.replace(old, f"[route]\nlayers={route}\n{extra}")
    text = text.replace("[maxpool]\nstride=1\nsize=9", f"[maxpool]\nstride=1\nsize={pool2}")
    path = tmp_path / "variant.cfg"
    path.write_text(text)
    return from_cfg(str(path))


# ---------------------------------------------------------------------------
# the matcher


@pytest.mark.parametrize("cfg,first", [(V4_CFG, 108), (MINI_CFG, 13)])
def test_the_matcher_finds_the_one_spp_block_of_yolov4(cfg, first):
    spec = from_cfg(cfg)
    blocks = darknet.spp_blocks(spec)
    assert list(blocks) == [first]
    blk = blocks[first]
    assert blk == darknet.SppBlock(input=first - 1, kernels=(5, 9, 13), order=(2, 1, 0, -1),
                                   route=first + 5)
    route = spec.layers[blk.route]
    assert isinstance(route, RouteSpec) and route.layers == (first + 4, first + 2, first,
                                                             first - 1)
    # the joined map is four times the input's channels, in the route's order
    assert spec.out_channels[blk.route] == 4 * spec.out_channels[blk.input]
    assert [spec.layers[p].kernel for p in route.layers[:3]] == [13, 9, 5]


@pytest.mark.parametrize("which", ["yolov3-416", "yolov3-512a", "yolov3_spec", "tiny-k2"])
def test_the_matcher_finds_nothing_in_yolov3_or_in_k2_pools(tmp_path, which):
    if which == "yolov3_spec":
        spec = yolov3_spec(num_classes=2)
    elif which == "tiny-k2":
        path = tmp_path / "tiny.cfg"
        path.write_text(TINY_CFG)
        spec = from_cfg(str(path))
        # the shape of an SPP block, but with pools of 2 (the kernel-2/stride-1
        # pool takes the reference's zero pad, not -inf)
        assert sum(isinstance(l, MaxPoolSpec) for l in spec.layers) == 3
    else:
        spec = from_cfg(V3_CFGS[0 if which == "yolov3-416" else 1])
    assert darknet.spp_blocks(spec) == {}


def test_the_matcher_takes_any_route_order_and_kernels(tmp_path):
    spec = _with_spp(tmp_path, "-6,-1,-5,-3", pool2="3")
    assert darknet.spp_blocks(spec) == {
        13: darknet.SppBlock(input=12, kernels=(5, 3, 13), order=(-1, 2, 0, 1), route=18)}


@pytest.mark.parametrize("route,extra", [
    ("-1,-3,-5", ""),                            # the input left out of the join
    ("-1,-3,-5,-6,-6", ""),                      # the input twice
    ("-1,-3,-5,-6", "[route]\nlayers=-2\n\n"),   # a pool read after the block
    ("-1,-3,-5,-6", "[route]\nlayers=-3\n\n"),   # a route back read after the block
])
def test_the_matcher_refuses_a_block_whose_layers_leave_it(tmp_path, route, extra):
    assert darknet.spp_blocks(_with_spp(tmp_path, route, extra)) == {}


@pytest.mark.parametrize("pool2", ["1", "23"])
def test_the_matcher_refuses_pools_the_kernel_does_not_take(tmp_path, pool2):
    # a 1-wide pool copies its input; a 23-wide one's halo passes a tile
    assert darknet.spp_blocks(_with_spp(tmp_path, "-1,-3,-5,-6", pool2=pool2)) == {}
    assert 13 in darknet.spp_blocks(_with_spp(tmp_path, "-1,-3,-5,-6", pool2="21"))


def test_the_matcher_refuses_a_stride_2_pool(tmp_path):
    text = open(MINI_CFG).read().replace("[maxpool]\nstride=1\nsize=5",
                                         "[maxpool]\nstride=2\nsize=5")
    path = tmp_path / "s2.cfg"
    path.write_text(text)
    assert darknet.spp_blocks(from_cfg(str(path))) == {}


# ---------------------------------------------------------------------------
# the plain version


def _special(b, c, h, w, dtype, gen, device="cpu"):
    """Mostly negative values with zeros of either sign (windows whose
    maximum is a tie of -0.0 and +0.0), a few -inf and NaN."""
    x = -torch.rand(b, c, h, w, generator=gen)
    u = torch.rand(b, c, h, w, generator=gen)
    x = torch.where(u < 0.3, torch.where(u < 0.15, -0.0, 0.0), x)
    x = torch.where((u > 0.5) & (u < 0.52), float("-inf"), x)
    x = torch.where(u > 0.995, float("nan"), x)
    return x.to(dtype).to(device).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,order", [
    ((2, 16, 19, 19), (2, 1, 0, -1)),   # YOLOv4's order
    ((1, 8, 5, 7), (2, 1, 0, -1)),      # a map smaller than 13
    ((3, 24, 9, 6), (-1, 0, 2, 1)),     # another order
])
@pytest.mark.parametrize("values", ["normal", "special"])
def test_plain_is_max_pool2d_and_cat(dtype, shape, order, values):
    gen = torch.Generator().manual_seed(3)
    if values == "normal":
        x = torch.randn(*shape, generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)
    else:
        x = _special(*shape, dtype, gen)
    got = spp_pool_plain(x, (5, 9, 13), order)
    pools = {j: F.max_pool2d(x, k, 1, padding=(k - 1) // 2) for j, k in enumerate((5, 9, 13))}
    want = torch.cat([x if o < 0 else pools[o] for o in order], dim=1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _same_bits(got, want)
    if values == "special":
        # a window with a NaN is NaN; -inf and both zeros reach the output
        assert torch.isnan(got).any() and (got == float("-inf")).any()
        zeros = got[got == 0]
        assert (torch.signbit(zeros).any() and (~torch.signbit(zeros)).any())
    # the wrapper on the CPU is the plain version and launches nothing
    before = spp_pool.launches
    assert _same_bits(spp_pool(x, (5, 9, 13), order), got)
    assert spp_pool.launches == before


@pytest.mark.parametrize("kernels,order,match", [
    ((5, 8, 13), (2, 1, 0, -1), "odd pool kernels"),
    ((1, 5, 9), (2, 1, 0, -1), "odd pool kernels"),
    ((5, 9, 23), (2, 1, 0, -1), "odd pool kernels"),
    ((3, 5, 7, 9, 11), (4, 3, 2, 1, 0, -1), "odd pool kernels"),
    ((5, 9, 13), (2, 1, 0), "each of the 3 pools and the input"),
    ((5, 9, 13), (2, 1, 1, -1), "each of the 3 pools and the input"),
])
def test_a_block_the_kernel_cannot_mean_raises(kernels, order, match):
    x = torch.randn(1, 8, 5, 5)
    with pytest.raises(ValueError, match=match):
        spp_pool(x, kernels, order)


# ---------------------------------------------------------------------------
# the folded forward through the block


def _folded_mini(dtype, seed=5, n=2, size=64):
    spec = from_cfg(MINI_CFG)
    g = torch.Generator().manual_seed(seed)
    folded = darknet.fold_batchnorm(darknet.init_params(g, spec), spec)
    # He-scaled weights, so that the maps are not all near 0
    for k, v in folded.items():
        v["w"] = torch.randn(v["w"].shape, generator=g) * (2.0 / v["w"][0].numel()) ** 0.5
        v["b"] = 0.1 * torch.randn(v["b"].shape, generator=g)
    return spec, folded, torch.rand(n, size, size, 3, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_folded_forward_through_the_block_is_the_layers_bit_for_bit(monkeypatch, dtype):
    spec, folded, x = _folded_mini(dtype)
    calls = []
    real = darknet.spp_pool

    def counting(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(darknet, "spp_pool", counting)
    before = spp_pool.launches
    with torch.no_grad():
        got = darknet.apply_folded(folded, spec, x, compute_dtype=dtype,
                                   spp=darknet.spp_blocks(spec))
    assert calls == [((5, 9, 13), (2, 1, 0, -1))]
    assert spp_pool.launches == before   # the CPU launches nothing
    with torch.no_grad():
        want = darknet.apply_folded(folded, spec, x, compute_dtype=dtype)
    assert len(calls) == 1 and len(got) == len(want) == 2
    assert all(_same_bits(g, w) for g, w in zip(got, want))


def test_the_block_keeps_its_input_alive_for_a_later_reader(tmp_path, monkeypatch):
    # a route after the block back to the SPP's input: the block's bookkeeping
    # must not free it
    spec = _with_spp(tmp_path, "-1,-3,-5,-6", "[route]\nlayers=-1,-7\n\n")
    spp = darknet.spp_blocks(spec)
    assert 13 in spp
    g = torch.Generator().manual_seed(2)
    folded = darknet.fold_batchnorm(darknet.init_params(g, spec), spec)
    x = torch.rand(1, 64, 64, 3, generator=g)
    calls = []
    real = darknet.spp_pool
    monkeypatch.setattr(darknet, "spp_pool", lambda *a: calls.append(a[1:]) or real(*a))
    with torch.no_grad():
        got = darknet.apply_folded(folded, spec, x, compute_dtype=torch.float32, spp=spp)
        want = darknet.apply_folded(folded, spec, x, compute_dtype=torch.float32)
    assert len(calls) == 1
    assert all(_same_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("cfg,blocks", [(MINI_CFG, 1), (V3_CFGS[0], 0)])
def test_the_detector_finds_its_blocks_once_and_runs_them(monkeypatch, cfg, blocks):
    from amyloid_yolo_tpu_torch.detectors import Detector
    det = Detector(from_cfg(cfg), device="cpu", compute_dtype=torch.float32, model_size=64)
    assert len(det.spp) == blocks
    calls = []
    real = darknet.spp_pool
    monkeypatch.setattr(darknet, "spp_pool", lambda *a: calls.append(a[1:]) or real(*a))
    monkeypatch.setattr(darknet, "spp_blocks", lambda spec: pytest.fail("matched per call"))
    tiles = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 96, 96, 3)).astype(
        np.uint8))
    with torch.inference_mode():
        det.head_maps(tiles)
    assert len(calls) == blocks


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _kernel_vs_plain(x, kernels=(5, 9, 13), order=(2, 1, 0, -1), launches=1):
    want = spp_pool_plain(x, kernels, order)
    before = spp_pool.launches
    got = spp_pool(x, kernels, order)
    torch.cuda.synchronize()
    assert spp_pool.launches == before + launches
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _same_bits(got, want), (tuple(x.shape), x.dtype, kernels, order)


@pytest.mark.card
@pytest.mark.parametrize("values", ["normal", "special"])
def test_kernel_is_the_plain_version_at_yolov4s_shape(cuda, values):
    gen = torch.Generator().manual_seed(7)
    if values == "normal":
        x = (3 * torch.randn(64, 512, 19, 19, generator=gen)).to(torch.bfloat16).to(
            cuda).contiguous(memory_format=torch.channels_last)
    else:
        x = _special(64, 512, 19, 19, torch.bfloat16, gen, cuda)
    _kernel_vs_plain(x)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,order", [
    ((1, 512, 19, 19), (2, 1, 0, -1)),
    ((2, 512, 13, 13), (2, 1, 0, -1)),
    ((2, 256, 38, 38), (2, 1, 0, -1)),
    ((3, 72, 19, 19), (-1, 0, 2, 1)),   # channels not a multiple of 64
    ((2, 40, 5, 7), (1, -1, 2, 0)),     # a map smaller than 13
    ((2, 16, 38, 38), (2, 1, 0, -1)),   # one block's run of channels an image
])
def test_kernel_is_the_plain_version_on_other_shapes(cuda, dtype, shape, order):
    gen = torch.Generator().manual_seed(11)
    _kernel_vs_plain(_special(*shape, dtype, gen, cuda), order=order)
    x = torch.randn(*shape, generator=gen).to(dtype).to(cuda).contiguous(
        memory_format=torch.channels_last)
    _kernel_vs_plain(x, order=order)
    _kernel_vs_plain(x, kernels=(3, 21, 7), order=order)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,kernels", [
    ((1, 16, 76, 76), (5, 9, 13)),     # YOLOv4's SPP map at 2432
    ((2, 24, 152, 40), (5, 9, 13)),
    ((1, 8, 30, 300), (3, 21, 7)),     # the widest pool: 2x3 written pixels a tile
])
def test_the_kernel_tiles_a_map_larger_than_a_block(cuda, dtype, shape, kernels):
    gen = torch.Generator().manual_seed(4)
    _kernel_vs_plain(_special(*shape, dtype, gen, cuda), kernels=kernels)
    x = torch.randn(*shape, generator=gen).to(dtype).to(cuda).contiguous(
        memory_format=torch.channels_last)
    _kernel_vs_plain(x, kernels=kernels, order=(1, -1, 0, 2))


@pytest.mark.card
def test_nchw_and_misaligned_inputs_run_the_kernel(cuda):
    gen = torch.Generator().manual_seed(4)
    y = torch.randn(2, 64, 19, 19, generator=gen).to(torch.bfloat16).to(cuda)
    _kernel_vs_plain(y)   # made channels_last first
    # a channels_last view 2 bytes into its storage is copied to an aligned one
    flat = torch.randn(1 + 2 * 19 * 19 * 64, generator=gen).to(torch.bfloat16).to(cuda)
    z = flat[1:].view(2, 19, 19, 64).permute(0, 3, 1, 2)
    assert z.is_contiguous(memory_format=torch.channels_last) and z.data_ptr() % 16
    _kernel_vs_plain(z)


@pytest.mark.card
@pytest.mark.parametrize("dtype,c,match", [
    (torch.bfloat16, 20, "16-byte vectors"),
    (torch.float32, 6, "16-byte vectors"),
    (torch.float16, 64, "bf16 or float32"),
])
def test_inputs_the_kernel_cannot_take_raise_on_the_card(cuda, dtype, c, match):
    x = torch.randn(2, c, 19, 19).to(dtype).to(cuda).contiguous(
        memory_format=torch.channels_last)
    before = spp_pool.launches
    with pytest.raises(ValueError, match=match):
        spp_pool(x, (5, 9, 13), (2, 1, 0, -1))
    assert spp_pool.launches == before


@pytest.mark.card
def test_a_detector_call_runs_the_kernel_once_for_yolov4_and_never_for_yolov3(cuda,
                                                                              monkeypatch):
    from amyloid_yolo_tpu_torch.detectors import Detector
    rng = np.random.RandomState(0)
    tiles = torch.from_numpy(rng.randint(0, 256, (2, 1536, 1536, 3)).astype(np.uint8)).to(cuda)
    v3 = Detector(yolov3_spec(num_classes=2), device=cuda, model_size=416)
    with torch.inference_mode():
        before = spp_pool.launches
        v3.head_maps(tiles)
        torch.cuda.synchronize()
        assert spp_pool.launches == before
    det = Detector(from_cfg(V4_CFG), device=cuda, model_size=608)
    with torch.inference_mode():
        before = spp_pool.launches
        maps = det.head_maps(tiles)
        torch.cuda.synchronize()
        assert spp_pool.launches == before + 1
        monkeypatch.setattr(det, "spp", {})
        layers = det.head_maps(tiles)
        torch.cuda.synchronize()
    assert spp_pool.launches == before + 1
    assert all(_same_bits(a, b) for a, b in zip(maps, layers))
