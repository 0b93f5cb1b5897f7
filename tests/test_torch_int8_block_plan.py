"""K3's launch plan (``conv_block.plan_launch`` with ``int8_block.K3``) on
the CPU: the tilings it picks for the stage shapes of YOLOv3-416 and a
ragged unit fit in shared memory, cover every output exactly once, execute
at most 0.05 more MMA work than K3's row-strip tiling and fill the card; its
cost model is the fit of the committed H100 times; and a numpy model of the
kernel's tile arithmetic is bit-exact to the plain version and to the JAX
package's ``reference_block_int8``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.pallas.int8_block import pack_int8_block as jax_pack
from amyloid_yolo_tpu.pallas.int8_block import reference_block_int8
from amyloid_yolo_tpu_torch.kernels.conv_block import (
    MAX_SMEM_BYTES,
    Plan,
    feasible_plans,
    fit_cost_model,
    load_plan_times,
    plan_launch,
    plan_stats,
    smem_bytes,
    strip_work_ratio,
    tiles,
)
from amyloid_yolo_tpu_torch.kernels.int8_block import (
    COST_MODEL,
    K3,
    PLAN_TIMES,
    fused_residual_block_int8,
    fused_residual_block_int8_plain,
    pack_int8_block,
)

STAGES = [(208, 64), (104, 128), (52, 256), (26, 512), (13, 1024), (20, 128)]
CASES = [(b, h, c) for b in (1, 8, 32) for h, c in STAGES]
PICK_SLACK = 1.05  # measured time of the plan over the fastest tiling's
SX, S1, S_OUT = 0.011, 0.017, 0.023


def _id(case):
    b, h, c = case
    return f"B{b}-{h}x{h}x{c}"


def _plan(b, h, c, **kw):
    return plan_launch(b, h, h, c, 132, K3, **kw)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_fits_in_shared_memory(case):
    b, h, c = case
    plan = _plan(b, h, c)
    stats = plan_stats(b, h, h, c, plan, 132, K3)
    assert stats.smem == smem_bytes(h, h, c, plan, K3) <= MAX_SMEM_BYTES
    assert stats.blocks_per_sm >= 1
    assert c % plan.oc_tile == 0 and plan.oc_tile % plan.block_n == 0
    assert plan.block_m * plan.block_n == 8 * 64 * plan.warp_n  # 8 warps of 64 pixels
    # int8: the hidden map takes half of K2's bytes for the same tiling
    hidden = min(plan.strip + 2, h) * min(plan.col_tile + 2, h) + 1
    assert smem_bytes(h, h, c, plan) - stats.smem == hidden * (c // 2)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_covers_every_output_once(case):
    b, h, c = case
    plan = _plan(b, h, c)
    count = np.zeros((b, h, h, c // plan.oc_tile), np.int32)
    n = 0
    for img, r0, rows, c0, cols, oc0 in tiles(b, h, h, c, plan):
        assert oc0 % plan.oc_tile == 0
        count[img, r0:r0 + rows, c0:c0 + cols, oc0 // plan.oc_tile] += 1
        n += 1
    assert (count == 1).all()
    assert n == plan_stats(b, h, h, c, plan, 132, K3).grid


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_adds_little_work(case):
    b, h, c = case
    stats = plan_stats(b, h, h, c, _plan(b, h, c), 132, K3)
    assert 1.0 <= stats.work_ratio <= strip_work_ratio(h, h, c, K3) + 0.05


def test_strip_work_ratio_of_k3s_row_strip_tiling():
    # K3's first version: strips of pick_strip over its own shared memory,
    # a one-row halo, 128-channel output tiles; at these shapes its strips
    # are K2's, and so are the work ratios
    got = [strip_work_ratio(h, h, c, K3) for h, c in STAGES[:5]]
    np.testing.assert_allclose(got, [1.027, 1.031, 1.259, 1.591, 2.575], atol=1e-3)


@pytest.mark.parametrize("b", [8, 32])
def test_plan_fills_the_card(b):
    # at the batches the detector runs, every stage is within 0.1 of a whole
    # number of waves or runs at least 3
    for h, c in STAGES[:5]:
        w = plan_stats(b, h, h, c, _plan(b, h, c), 132, K3).waves
        assert w >= 3 or w - int(w) >= 0.9 or w == int(w), (h, c, w)


def test_cost_model_is_the_fit_to_the_measured_tilings():
    # COST_MODEL is what fit_cost_model makes of the committed H100 times
    sms, rows = load_plan_times(PLAN_TIMES)
    np.testing.assert_allclose(fit_cost_model(rows, sms, K3), COST_MODEL, rtol=0.01)
    assert K3.cost_model == COST_MODEL


@pytest.mark.parametrize("b", [8, 32])
def test_plan_is_near_the_fastest_measured_tiling(b):
    # the committed table times every feasible tiling of the five stages;
    # the plan is one of them, and within PICK_SLACK of the fastest
    sms, rows = load_plan_times(PLAN_TIMES)
    for h, c in STAGES[:5]:
        timed = {plan: s for bb, hh, _, cc, plan, s in rows if (bb, hh, cc) == (b, h, c)}
        assert set(timed) == set(feasible_plans(h, h, c, K3))
        pick = timed[plan_launch(b, h, h, c, sms, K3)]
        assert pick <= PICK_SLACK * min(timed.values()), (h, c, pick, min(timed.values()))


@pytest.mark.parametrize("strip", [4, 13, 26])
def test_callers_strip_restricts_the_plan(strip):
    plan = _plan(8, 52, 256, strip=strip)
    assert plan.strip == strip
    assert smem_bytes(52, 52, 256, plan, K3) <= MAX_SMEM_BYTES


def test_strip_that_fits_no_tiling_raises():
    with pytest.raises(ValueError, match="fits in shared memory"):
        _plan(1, 416, 1024, strip=416)


def test_plan_must_have_the_callers_strip():
    rng = np.random.RandomState(1)
    xq = torch.from_numpy(rng.randint(-127, 128, (1, 8, 8, 64)).astype(np.int8))
    pack = _port_pack(*_unit(rng, 64))
    with pytest.raises(ValueError, match="strip"):
        fused_residual_block_int8(xq, *pack, sx=SX, s1=S1, s_out=S_OUT, strip=4,
                                  plan=Plan(2, 8, 64, 64, 32))


def _unit(rng, c):
    """The reference test's ranges, HWIO: int8 weights, weight scales in
    [1e-3, 2e-2), biases in ±1."""
    c2 = c // 2
    return (rng.randint(-127, 128, (1, 1, c, c2)).astype(np.int8),
            rng.uniform(1e-3, 2e-2, c2).astype(np.float32),
            rng.uniform(-1, 1, c2).astype(np.float32),
            rng.randint(-127, 128, (3, 3, c2, c)).astype(np.int8),
            rng.uniform(1e-3, 2e-2, c).astype(np.float32),
            rng.uniform(-1, 1, c).astype(np.float32))


def _port_pack(w1q, ws1, b1, w2q, ws2, b2):
    def oihw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))

    w1t, pws1, pb1, w2t, pws2, pb2 = pack_int8_block(
        oihw(w1q), torch.from_numpy(ws1), torch.from_numpy(b1),
        oihw(w2q), torch.from_numpy(ws2), torch.from_numpy(b2))
    return w1t, pws1 * SX, pb1, w2t, pws2 * S1, pb2


def _leaky(v):
    return np.where(v >= 0, v, v * np.float32(0.1))


def _requant(v, s):
    inv = np.float32(1.0 / s)
    return np.clip(np.rint(v * inv), -127, 127).astype(np.int8)


def _tiled(x, w1t, a1, b1, w2t, a2, b2, plan):
    """The kernel's tile arithmetic in numpy: per tile, the 1x1 over the
    tile's in-image halo pixels (int64 products, the float32 epilogue one
    rounded operation at a time, requantized at s1), one zero pixel for
    every tap outside the image, the 3x3 from that compact tile, then the
    epilogue with the shortcut, requantized at s_out."""
    b, h, w, c = x.shape
    f32 = np.float32
    x64 = x.astype(np.int64)
    y = np.zeros_like(x)
    done = np.zeros(x.shape, bool)
    for img, r0, rows, c0, cols, oc0 in tiles(b, h, w, c, plan):
        hr0, hc0 = max(r0 - 1, 0), max(c0 - 1, 0)
        nhr = min(r0 + rows, h - 1) - hr0 + 1
        nhc = min(c0 + cols, w - 1) - hc0 + 1
        px = x64[img, hr0:hr0 + nhr, hc0:hc0 + nhc].reshape(-1, c)
        acc1 = px @ w1t.astype(np.int64).T
        hid = _requant(_leaky(acc1.astype(f32) * a1 + b1), S1).astype(np.int64)
        hid = np.concatenate([hid, np.zeros((1, c // 2), np.int64)])  # the zero pixel
        oc = slice(oc0, oc0 + plan.oc_tile)
        q = np.arange(rows * cols)
        r, col = r0 + q // cols, c0 + q % cols
        acc2 = np.zeros((rows * cols, plan.oc_tile), np.int64)
        for tap in range(9):
            hr, hc = r + tap // 3 - 1, col + tap % 3 - 1
            inside = (hr >= 0) & (hr < h) & (hc >= 0) & (hc < w)
            idx = np.where(inside, (hr - hr0) * nhc + hc - hc0, len(hid) - 1)
            acc2 += hid[idx] @ w2t[tap, oc].astype(np.int64).T
        v = _leaky(acc2.astype(f32) * a2[oc] + b2[oc])
        out = _requant(v + x[img, r, col][:, oc].astype(f32) * f32(SX), S_OUT)
        y[img, r, col, oc] = out
        assert not done[img, r, col, oc].any()
        done[img, r, col, oc] = True
    assert done.all()
    return y


@pytest.mark.parametrize("shape,plan", [
    ((2, 7, 9, 64), Plan(3, 4, 64, 64, 32)),      # ragged rows and columns
    ((1, 10, 11, 128), Plan(4, 5, 64, 64, 32)),   # two output-channel tiles
    ((1, 6, 13, 128), Plan(6, 6, 128, 128, 64)),  # one strip, ragged columns
    ((2, 5, 6, 64), Plan(2, 6, 64, 64, 32)),      # whole rows, ragged strips
])
def test_tile_arithmetic_is_bitexact(shape, plan):
    b, h, w, c = shape
    rng = np.random.RandomState(sum(shape))
    unit = _unit(rng, c)
    xq = rng.randint(-127, 128, shape).astype(np.int8)
    pack = _port_pack(*unit)
    got = _tiled(xq, *(t.numpy() for t in pack), plan)
    plain = fused_residual_block_int8_plain(torch.from_numpy(xq), *pack,
                                            sx=SX, s1=S1, s_out=S_OUT).numpy()
    np.testing.assert_array_equal(got, plain)
    jw1, ja1, jb1, jw2, ja2, jb2 = jax_pack(*unit)
    want = reference_block_int8(jnp.asarray(xq), jw1, ja1 * SX, jb1, jw2, ja2 * S1, jb2,
                                sx=SX, s1=S1, s_out=S_OUT)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the reference's ranges saturate part of the outputs; the rest rounds
    assert 0 < (np.abs(got) < 127).mean() < 1
