"""K2's launch plan (``kernels/conv_block.py:plan_launch``) on the CPU: the
tilings it picks for the stage shapes of YOLOv3-416 and a ragged unit fit in
shared memory, cover every output exactly once, and execute at most 0.05
more MMA work than the row-strip tiling; a model of the kernel's tile
arithmetic, with the warpgroups, warps and lanes of its ``wgmma`` 3x3,
reproduces the plain version."""

import numpy as np
import pytest
import torch

from amyloid_yolo_tpu_torch.kernels.conv_block import (
    COST_MODEL,
    K2,
    MAX_SMEM_BYTES,
    Plan,
    feasible_plans,
    fit_cost_model,
    conv3x3_path,
    fused_residual_block_plain,
    load_plan_times,
    plan_launch,
    plan_stats,
    smem_bytes,
    strip_work_ratio,
    tiles,
)

STAGES = [(208, 64), (104, 128), (52, 256), (26, 512), (13, 1024), (20, 128)]
CASES = [(b, h, c) for b in (1, 8, 32) for h, c in STAGES]
PICK_SLACK = 1.05  # measured time of the plan over the fastest tiling's


def _id(case):
    b, h, c = case
    return f"B{b}-{h}x{h}x{c}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_fits_in_shared_memory(case):
    b, h, c = case
    plan = plan_launch(b, h, h, c)
    stats = plan_stats(b, h, h, c, plan)
    assert stats.smem == smem_bytes(h, h, c, plan) <= MAX_SMEM_BYTES
    assert stats.blocks_per_sm >= 1
    assert c % plan.oc_tile == 0 and plan.oc_tile % plan.block_n == 0
    assert plan.block_m * plan.block_n == 8 * 64 * plan.warp_n  # 8 warps of 64 pixels


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_covers_every_output_once(case):
    b, h, c = case
    plan = plan_launch(b, h, h, c)
    count = np.zeros((b, h, h, c // plan.oc_tile), np.int32)
    n = 0
    for img, r0, rows, c0, cols, oc0 in tiles(b, h, h, c, plan):
        assert oc0 % plan.oc_tile == 0
        count[img, r0:r0 + rows, c0:c0 + cols, oc0 // plan.oc_tile] += 1
        n += 1
    assert (count == 1).all()
    assert n == plan_stats(b, h, h, c, plan).grid


# K2's picks at every case, as fitted to conv_block_plan_times.json; the
# planner serves K3 too, and K2's tilings must not move with it
K2_PICKS = {
    (1, 208, 64): (5, 35, 64, 64, 32), (1, 104, 128): (6, 21, 128, 128, 64),
    (1, 52, 256): (4, 8, 128, 128, 32), (1, 26, 512): (4, 4, 256, 256, 64),
    (1, 13, 1024): (2, 7, 256, 256, 64), (1, 20, 128): (3, 5, 128, 128, 64),
    (8, 208, 64): (8, 30, 64, 64, 32), (8, 104, 128): (8, 21, 128, 64, 32),
    (8, 52, 256): (13, 13, 256, 128, 64), (8, 26, 512): (7, 13, 256, 256, 64),
    (8, 13, 1024): (7, 7, 256, 256, 64), (8, 20, 128): (3, 5, 128, 128, 32),
    (32, 208, 64): (13, 30, 64, 64, 32), (32, 104, 128): (13, 18, 128, 128, 32),
    (32, 52, 256): (9, 13, 256, 128, 32), (32, 26, 512): (7, 13, 512, 256, 64),
    (32, 13, 1024): (7, 13, 512, 128, 32), (32, 20, 128): (10, 10, 64, 64, 32),
}


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_k2_picks_are_unchanged(case):
    b, h, c = case
    assert tuple(plan_launch(b, h, h, c)) == K2_PICKS[case]
    assert tuple(plan_launch(b, h, h, c, 132, K2)) == K2_PICKS[case]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_adds_little_work(case):
    b, h, c = case
    stats = plan_stats(b, h, h, c, plan_launch(b, h, h, c))
    assert 1.0 <= stats.work_ratio <= strip_work_ratio(h, h, c) + 0.05


def test_strip_work_ratio_of_the_row_strip_tiling():
    # 8-row strips, a one-row halo and 64-pixel warp tiles; 128-channel
    # output tiles recompute the 1x1 at 256 channels and more
    got = [strip_work_ratio(h, h, c) for h, c in STAGES[:5]]
    np.testing.assert_allclose(got, [1.027, 1.031, 1.259, 1.591, 2.575], atol=1e-3)


@pytest.mark.parametrize("b", [8, 32])
def test_plan_fills_the_card(b):
    # at the batches the detector runs, every stage is within 0.1 of a whole
    # number of waves or runs at least 3
    for h, c in STAGES[:5]:
        w = plan_stats(b, h, h, c, plan_launch(b, h, h, c)).waves
        assert w >= 3 or w - int(w) >= 0.9 or w == int(w), (h, c, w)


def test_cost_model_is_the_fit_to_the_measured_tilings():
    # COST_MODEL is what fit_cost_model makes of the committed H100 times
    sms, rows = load_plan_times()
    np.testing.assert_allclose(fit_cost_model(rows, sms), COST_MODEL, rtol=0.01)


@pytest.mark.parametrize("b", [8, 32])
def test_plan_is_near_the_fastest_measured_tiling(b):
    # the committed table times every feasible tiling of the five stages;
    # the plan is one of them, and within PICK_SLACK of the fastest
    sms, rows = load_plan_times()
    for h, c in STAGES[:5]:
        timed = {plan: s for bb, hh, _, cc, plan, s in rows if (bb, hh, cc) == (b, h, c)}
        assert set(timed) == set(feasible_plans(h, h, c))
        pick = timed[plan_launch(b, h, h, c, sms)]
        assert pick <= PICK_SLACK * min(timed.values()), (h, c, pick, min(timed.values()))


def _leaky(v):
    return np.where(v >= 0, v, v * np.float32(0.1))


def _bf16(v):
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16).float().numpy()


# wgmma's accumulator layout, per lane of a warp's 16 x N tile: element 4j + e
# is row g + 8 * (e // 2), column 8j + 2 * (lane % 4) + e % 2, with g = lane // 4
_LANE = np.arange(32)[:, None]


def _acc_index(n):
    e = np.arange(n // 2)[None, :]
    return _LANE // 4 + 8 * (e % 4 // 2), 8 * (e // 4) + 2 * (_LANE % 4) + e % 2


def _wgmma_3x3(rows_of, w2t, plan, m2):
    """The kernel's wgmma 3x3 of one tile, (m2, oc_tile) f32: per block tile
    (m chunk x n chunk) each warpgroup g owns rows g * BM / 2 + [0, BM / 2) as
    m64 blocks, warp w of it rows 16 * (w % 4) of each block; every block
    issues, rows past the tile's pixels read the zero pixel (``rows_of``
    maps pixel indices to hidden rows, those >= m2 to the zero pixel).  The
    products land in each lane's accumulators in wgmma's layout, and the
    epilogue stores them from there, rows past the tile's pixels nowhere."""
    bm, bn = plan.block_m, plan.block_n
    out = np.full((m2, plan.oc_tile), np.nan, np.float32)
    stores = np.zeros((m2, plan.oc_tile), np.int32)
    arow, acol = _acc_index(bn)
    g, tq = _LANE[:, 0] // 4, _LANE[:, 0] % 4
    for mc in range(-(-m2 // bm)):
        for nc in range(plan.oc_tile // bn):
            ns = slice(nc * bn, (nc + 1) * bn)
            for wg in range(2):
                for mb in range(bm // 128):
                    for wr in range(4):
                        base = mc * bm + wg * bm // 2 + mb * 64 + wr * 16
                        q = base + np.arange(16)
                        d = sum(rows_of(tap, q) @ w2t[tap, ns].T for tap in range(9))
                        acc = d[arow, acol]  # (lane, bn / 2)
                        for hh in range(2):
                            qq = base + hh * 8 + g
                            for ni in range(bn // 8):
                                for e in range(2):
                                    ok = qq < m2
                                    col = nc * bn + ni * 8 + 2 * tq + e
                                    out[qq[ok], col[ok]] = acc[ok, ni * 4 + hh * 2 + e]
                                    stores[qq[ok], col[ok]] += 1
    assert (stores == 1).all()  # every output of the tile stored once
    return out


def _tiled(x, w1t, b1, w2t, b2, plan):
    """The kernel's tile arithmetic in numpy, f32 with the hidden map rounded
    to bf16: per tile, the 1x1 over the tile's in-image halo pixels, one zero
    pixel for every tap outside the image, the 3x3 from that compact tile
    (as :func:`_wgmma_3x3` where the kernel runs wgmma)."""
    b, h, w, c = x.shape
    y = np.full_like(x, np.nan)
    for img, r0, rows, c0, cols, oc0 in tiles(b, h, w, c, plan):
        hr0, hc0 = max(r0 - 1, 0), max(c0 - 1, 0)
        nhr = min(r0 + rows, h - 1) - hr0 + 1
        nhc = min(c0 + cols, w - 1) - hc0 + 1
        px = x[img, hr0:hr0 + nhr, hc0:hc0 + nhc].reshape(-1, c)
        hid = _bf16(_leaky(px @ w1t.T + b1))
        hid = np.concatenate([hid, np.zeros((1, c // 2), np.float32)])  # the zero pixel
        oc = slice(oc0, oc0 + plan.oc_tile)
        m2 = rows * cols

        def rows_of(tap, q):
            hr, hc = r0 + q // cols + tap // 3 - 1, c0 + q % cols + tap % 3 - 1
            inside = (q < m2) & (hr >= 0) & (hr < h) & (hc >= 0) & (hc < w)
            return hid[np.where(inside, (hr - hr0) * nhc + hc - hc0, len(hid) - 1)]

        q = np.arange(m2)
        if conv3x3_path(c) == "wgmma":
            acc = _wgmma_3x3(rows_of, w2t[:, oc], plan, m2)
        else:
            acc = sum(rows_of(tap, q) @ w2t[tap, oc].T for tap in range(9))
        r, col = r0 + q // cols, c0 + q % cols
        out = x[img, r, col][:, oc] + _leaky(acc + b2[oc])
        y[img, r, col, oc0:oc0 + plan.oc_tile] = out
    return y


@pytest.mark.parametrize("shape,plan", [
    ((2, 7, 9, 64), Plan(3, 4, 64, 64)),
    ((1, 20, 20, 128), Plan(3, 20, 64, 64)),
    ((1, 5, 6, 128), Plan(5, 6, 128, 128)),
    # the wgmma 3x3's block tiles: 64- and 128-channel warpgroup products at
    # BM = 256 (two m64 blocks a warpgroup) and 128 and 256 at BM = 128, on
    # tiles whose pixels fill no whole m64 block or leave one wholly empty
    ((1, 13, 13, 128), Plan(13, 13, 128, 128, 64)),
    ((1, 5, 6, 128), Plan(5, 6, 128, 64, 32)),
    ((1, 6, 7, 512), Plan(6, 7, 256, 128, 32)),
    ((2, 7, 9, 256), Plan(3, 9, 256, 256, 64)),
])
def test_tile_arithmetic_matches_plain(rng, shape, plan):
    b, h, w, c = shape
    x = rng.randn(b, h, w, c).astype(np.float32)
    w1t = (rng.randn(c // 2, c) / np.sqrt(c)).astype(np.float32)
    w2t = (rng.randn(9, c, c // 2) / np.sqrt(9 * c // 2)).astype(np.float32)
    b1 = (0.1 * rng.randn(c // 2)).astype(np.float32)
    b2 = (0.1 * rng.randn(c)).astype(np.float32)
    got = _tiled(x, w1t, b1, w2t, b2, plan)
    # the plain version rounds the hidden map to x's dtype: give it f32 x and
    # compare with a bf16-rounded hidden by building it the same way
    t = [torch.from_numpy(a) for a in (x, w1t, b1, w2t, b2)]
    xf, w1, bb1, w2, bb2 = t
    hid = torch.from_numpy(_bf16(_leaky((xf @ w1.t() + bb1).numpy())))
    conv = torch.nn.functional.conv2d(
        hid.permute(0, 3, 1, 2), w2.reshape(3, 3, c, c // 2).permute(2, 3, 0, 1), padding=1)
    want = (xf + torch.from_numpy(_leaky((conv.permute(0, 2, 3, 1) + bb2).numpy()))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the plain version itself on the same f32 inputs agrees up to the
    # bf16 rounding of the hidden map
    plain = fused_residual_block_plain(*t).numpy()
    np.testing.assert_allclose(got, plain, rtol=0.05, atol=0.05)
