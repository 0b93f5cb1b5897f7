"""The port's target assignment, training decode and YOLO loss against the
JAX package's (``ops/targets.py`` in its ``"scatter"`` form,
``models/heads.py:head_grid_tensors``, ``ops/loss.py``).  The reference's
``"dense"`` form, which the port does not have, is rendered in torch here
(:func:`_assemble_dense`) and held against the JAX dense form and against
the port's scatter assembly, bit for bit.

Tolerances: the masks and ``tcls`` are compared for equality; the float
targets and decode tensors to 1e-6 (the same float32 operations, the
transcendental functions of two libraries); the loss, its terms and the
per-head metrics to a relative 1e-5; the gradient with respect to the head
maps to a relative 1e-5 of its largest value.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.graphspec import YoloSpec as JaxYoloSpec
from amyloid_yolo_tpu.models.heads import head_grid_tensors as jax_head_grid_tensors
from amyloid_yolo_tpu.ops.boxes import bbox_wh_iou as jax_bbox_wh_iou
from amyloid_yolo_tpu.ops.loss import yolo_loss as jax_yolo_loss
from amyloid_yolo_tpu.ops.targets import build_targets as jax_build_targets
from amyloid_yolo_tpu_torch.graphspec import YoloSpec
from amyloid_yolo_tpu_torch.models.heads import head_grid_tensors
from amyloid_yolo_tpu_torch.ops.boxes import bbox_wh_iou
from amyloid_yolo_tpu_torch.ops.loss import yolo_head_loss, yolo_loss
from amyloid_yolo_tpu_torch.ops import targets as targets_mod
from amyloid_yolo_tpu_torch.ops.targets import build_targets

from minispec import mini_spec
from torch_port_helpers import port_mini_spec

ANCHORS = ((10, 13), (16, 30), (33, 23))
YOLO = YoloSpec(index=0, anchors=ANCHORS, num_classes=2)
JYOLO = JaxYoloSpec(index=0, anchors=ANCHORS, num_classes=2)
VAL_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
MINI = mini_spec()


def _case(seed, b=2, g=8, n_t=8, n_pad=0):
    r = np.random.RandomState(seed)
    raw = (r.randn(b, g, g, 3 * 7) * 0.5).astype(np.float32)
    t = np.zeros((n_t + n_pad, 6), np.float32)
    t[:n_t, 0] = r.randint(0, b, n_t)
    t[:n_t, 1] = r.randint(0, 2, n_t)
    t[:n_t, 2:4] = r.rand(n_t, 2) * 0.9 + 0.05
    t[:n_t, 4:6] = r.rand(n_t, 2) * 0.3 + 0.05
    t[n_t:] = 0.5 + r.rand(n_pad, 6)  # garbage padding rows
    mask = np.arange(n_t + n_pad) < n_t
    return raw, t, mask


@functools.partial(jax.jit, static_argnames=("img", "form"))
def _jax_targets(raw, t, mask, img, form="scatter"):
    jt = jax_head_grid_tensors(raw, ANCHORS, img, 2)
    return jax_build_targets(jt["pred_boxes"], jt["cls"], t, mask, jt["scaled_anchors"],
                             JYOLO.ignore_thres, form=form)


@jax.jit
def _jax_loss(maps, t, mask):
    return jax_yolo_loss(maps, MINI, 64, t, mask)


def _assemble_dense(ncell, nC, key, key_ign, order, valid, labels_c, values):
    """The reference's dense assembly (``amyloid_yolo_tpu/ops/targets.py:
    155-211``) in torch, with :func:`targets._assemble_scatter`'s arguments
    and results: each write becomes a compare of the T target keys against
    every cell, reduced over T.  The winner is the largest target row of a
    cell (last writer wins) and its values are gathered, not summed;
    ``tcls`` is a bf16 product of the (T, ncell) hits and the class one-hot,
    accumulated in float32 (exact while T < 256)."""
    cell = torch.arange(ncell)
    hit = key[:, None] == cell[None, :]                                   # (T, ncell)
    winner = torch.where(hit, order.to(torch.int32)[:, None], -1).amax(dim=0)
    assigned = winner >= 0
    vals = torch.where(assigned[:, None], values[winner.clamp(min=0).long()], 0.0)
    ignored = (key_ign[:, None] == cell[None, :]).any(dim=0)
    onehot = labels_c[:, None] == torch.arange(nC)[None, :]
    counts = hit.to(torch.bfloat16).t().matmul(onehot.to(torch.bfloat16))  # (ncell, C)
    return assigned, ~(assigned | ignored), vals, (counts > 0).to(torch.float32).reshape(-1)


def _targets_pair(raw, t, mask, img=64, form="scatter"):
    """The JAX package's targets in ``form`` and the port's, its assembly
    replaced by :func:`_assemble_dense` for ``form="dense"``."""
    ref = _jax_targets(jnp.asarray(raw), jnp.asarray(t), jnp.asarray(mask), img, form)
    pt = head_grid_tensors(torch.from_numpy(raw), ANCHORS, img, 2)
    assemble = _assemble_dense if form == "dense" else targets_mod._assemble_scatter
    with mock.patch.object(targets_mod, "_assemble_scatter", assemble):
        got = build_targets(pt["pred_boxes"], pt["cls"], torch.from_numpy(t),
                            torch.from_numpy(mask), pt["scaled_anchors"], YOLO.ignore_thres)
    return ref, got


def _assert_targets(ref, got):
    assert set(ref) == set(got)
    for k in ref:
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == b.shape, k
        if a.dtype == bool or k in ("tcls", "tconf", "class_mask"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=VAL_TOL, err_msg=k)


@pytest.mark.parametrize("seed,n_pad", [(0, 0), (1, 5), (2, 17)])
def test_build_targets_matches_jax(seed, n_pad):
    raw, t, mask = _case(seed, b=3, g=13, n_t=24, n_pad=n_pad)
    t[5] = t[0]               # a duplicate row
    t[6, 2:4] = t[1, 2:4]     # a shared centre
    ref, got = _targets_pair(raw, t, mask, img=104)
    _assert_targets(ref, got)


def test_build_targets_padded_rows_drop_out():
    raw, t, mask = _case(3, n_t=4, n_pad=3)
    _, alone = _targets_pair(raw, t[:4], mask[:4])
    _, padded = _targets_pair(raw, t, mask)
    for k in alone:
        np.testing.assert_array_equal(padded[k].numpy(), alone[k].numpy(), err_msg=k)


def test_same_cell_collision_last_writer_wins():
    """``tests/test_targets_loss.py:66``'s case: two GTs in one cell with one
    best anchor; the later row's regression targets win, both classes set."""
    raw = np.random.RandomState(0).randn(1, 8, 8, 21).astype(np.float32)
    t = np.array([[0, 0, 0.52, 0.52, 0.10, 0.10],
                  [0, 1, 0.53, 0.53, 0.11, 0.11]], np.float32)
    ref, got = _targets_pair(raw, t, np.ones(2, bool))
    _assert_targets(ref, got)
    cell = (0, int(got["obj_mask"][0].nonzero()[0][0]), 4, 4)
    assert int(got["obj_mask"].sum()) == 1
    np.testing.assert_allclose(float(got["tx"][cell]), 0.53 * 8 - 4, atol=1e-5)
    np.testing.assert_array_equal(got["tcls"][cell].numpy(), [1.0, 1.0])


def _crowded_case(seed, n_pad):
    """``_case`` with two rows in one cell of one anchor under distinct
    classes, a duplicate row and a shared centre."""
    raw, t, mask = _case(seed, b=3, g=13, n_t=24, n_pad=n_pad)
    t[5] = t[0]
    t[6, 2:4] = t[1, 2:4]
    t[7] = t[2]
    t[7, 1] = 1 - t[2, 1]
    t[7, 2:4] += 0.001
    return raw, t, mask


@pytest.mark.parametrize("seed,n_pad", [(0, 0), (1, 5), (2, 17), (3, 3)])
def test_dense_form_equals_scatter_and_jax_dense(seed, n_pad):
    """The dense assembly in ``build_targets`` is bit-identical to the port's
    scatter form, and holds against the JAX package's dense form as the
    scatter form holds against its scatter form (``_assert_targets``)."""
    raw, t, mask = _crowded_case(seed, n_pad)
    ref, dense = _targets_pair(raw, t, mask, img=104, form="dense")
    _, scatter = _targets_pair(raw, t, mask, img=104, form="scatter")
    _assert_targets(ref, dense)
    cell = np.argwhere(dense["tcls"].numpy().sum(-1) == 2)
    assert len(cell) >= 1  # two classes set in one cell
    for k in scatter:
        assert dense[k].dtype == scatter[k].dtype, k
        np.testing.assert_array_equal(dense[k].numpy(), scatter[k].numpy(), err_msg=k)
        assert torch.equal(torch.signbit(dense[k].float()), torch.signbit(scatter[k].float()))


@pytest.mark.parametrize("seed", range(3))
def test_dense_assembly_bit_identical_to_jax(seed):
    """The dense assembly itself on the same per-target keys and values as
    the JAX package's ``_assemble_dense``, and the port's scatter assembly
    on them: every output equal bit for bit, winners of crowded cells,
    distinct classes in one cell and padded rows included.  (Through
    ``build_targets`` the float targets differ by the two libraries' ``log``
    and ``exp``, within ``VAL_TOL``.)"""
    from amyloid_yolo_tpu.ops.targets import _assemble_dense as jax_assemble

    r = np.random.RandomState(50 + seed)
    nB, nA, nG, nC, nT = 2, 3, 5, 2, 40
    b = r.randint(0, nB, nT)
    best_n, gj, gi = r.randint(0, nA, nT), r.randint(0, 2, nT), r.randint(0, 2, nT)
    valid = r.rand(nT) > 0.2
    labels = r.randint(0, nC, nT)
    ign = r.rand(nA, nT) > 0.6
    vals = r.randn(6, nT).astype(np.float32)
    vals[0, :3] = -0.0
    ncell = nB * nA * nG * nG
    b_s = np.where(valid, b, nB)
    key = np.where(valid, ((b_s * nA + best_n) * nG + gj) * nG + gi, ncell)
    key_ign = ((b_s[None] * nA + np.arange(nA)[:, None]) * nG + gj[None]) * nG + gi[None]
    key_ign = np.where(ign & valid[None], key_ign, ncell).reshape(-1)
    j = lambda a: jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a)  # noqa: E731
    ref = jax_assemble(nB, nA, nG, nC, ncell, j(key), j(np.arange(nT)), j(valid), j(labels),
                       j(ign), j(b_s), j(gj), j(gi), *[j(v) for v in vals])
    t = torch.from_numpy
    args = (ncell, nC, t(key), t(key_ign), t(np.arange(nT)), t(valid), t(labels),
            t(vals.T.copy()))
    obj, noobj, got, tcls = _assemble_dense(*args)
    for have, want in zip((obj, noobj, got, tcls), targets_mod._assemble_scatter(*args)):
        assert torch.equal(have, want) and torch.equal(torch.signbit(have.float()),
                                                       torch.signbit(want.float()))
    shape = (nB, nA, nG, nG)
    np.testing.assert_array_equal(obj.reshape(shape).numpy(), np.asarray(ref["obj_mask"]))
    np.testing.assert_array_equal(noobj.reshape(shape).numpy(), np.asarray(ref["noobj_mask"]))
    np.testing.assert_array_equal(tcls.reshape(*shape, nC).numpy(), np.asarray(ref["tcls"]))
    for i, k in enumerate(("tx", "ty", "tw", "th", "iou_scores", "class_mask")):
        want = np.asarray(ref[k])
        have = got[:, i].reshape(shape).numpy()
        np.testing.assert_array_equal(have, want, err_msg=k)
        np.testing.assert_array_equal(np.signbit(have), np.signbit(want), err_msg=k)
    assert (np.asarray(ref["tcls"]).sum(-1) == 2).any() and obj.sum() < valid.sum()


def test_head_grid_tensors_and_wh_iou_match_jax():
    raw, t, _ = _case(4, b=2, g=8)
    ref = jax_head_grid_tensors(jnp.asarray(raw), ANCHORS, 64, 2)
    got = head_grid_tensors(torch.from_numpy(raw), ANCHORS, 64, 2)
    for k in ("x", "y", "w", "h", "conf", "cls", "pred_boxes", "scaled_anchors"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=VAL_TOL, err_msg=k)
    assert got["stride"] == ref["stride"] and got["grid_size"] == ref["grid_size"]
    anc = np.asarray(ANCHORS, np.float32) / 8.0
    wh = t[:, 4:6] * 8
    np.testing.assert_allclose(bbox_wh_iou(torch.from_numpy(anc), torch.from_numpy(wh)).numpy(),
                               np.asarray(jax_bbox_wh_iou(jnp.asarray(anc), jnp.asarray(wh))),
                               rtol=1e-7, atol=0)


def _loss_pair(seed, n_pad=3):
    """Random maps for the mini spec's three yolo layers (grids 2, 4, 8)."""
    r = np.random.RandomState(seed)
    maps = [(r.randn(2, g, g, 21) * 1.5).astype(np.float32) for g in (2, 4, 8)]
    _, t, mask = _case(seed, b=2, n_t=10, n_pad=n_pad)
    return maps, t, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_yolo_loss_and_metrics_match_jax(seed):
    maps, t, mask = _loss_pair(seed)
    ref_total, ref_heads = _jax_loss([jnp.asarray(m) for m in maps], jnp.asarray(t),
                                     jnp.asarray(mask))
    total, heads = yolo_loss([torch.from_numpy(m) for m in maps], port_mini_spec(), 64,
                             torch.from_numpy(t), torch.from_numpy(mask))
    np.testing.assert_allclose(float(total), float(ref_total), rtol=LOSS_RTOL)
    assert len(heads) == len(ref_heads) == 3
    for h, rh in zip(heads, ref_heads):
        assert set(h) == set(rh)
        for k in rh:
            np.testing.assert_allclose(float(h[k]), float(rh[k]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)


def test_loss_without_targets_is_zero_terms_and_finite():
    raw = np.zeros((1, 8, 8, 21), np.float32)
    t = np.zeros((3, 6), np.float32)
    total, m = yolo_head_loss(torch.from_numpy(raw), YOLO, 64, torch.from_numpy(t),
                              torch.zeros(3, dtype=torch.bool))
    assert torch.isfinite(total)
    for k in ("x", "y", "w", "h", "cls", "cls_acc"):
        assert float(m[k]) == 0.0, k
    # only the no-object confidence term remains: 100 · BCE(0.5, 0)
    np.testing.assert_allclose(float(total), 100 * np.log(2), rtol=1e-6)


def test_loss_gradient_wrt_head_maps_matches_jax():
    maps, t, mask = _loss_pair(7)

    def jax_total(ms):
        return jax_yolo_loss(ms, MINI, 64, jnp.asarray(t), jnp.asarray(mask))[0]

    ref = jax.jit(jax.grad(jax_total))([jnp.asarray(m) for m in maps])
    xs = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    total, _ = yolo_loss(xs, port_mini_spec(), 64, torch.from_numpy(t), torch.from_numpy(mask))
    total.backward()
    for x, r in zip(xs, ref):
        r = np.asarray(r)
        assert np.isfinite(x.grad.numpy()).all()
        np.testing.assert_allclose(x.grad.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * np.abs(r).max())


def test_loss_backward_after_an_inference_mode_decode():
    """A ``Detector`` decodes under ``torch.inference_mode``; the anchors it
    caches must still serve a training loss's backward afterwards."""
    from amyloid_yolo_tpu_torch.models import heads

    maps, t, mask = _loss_pair(8)
    heads._grid_anchors.cache_clear()
    with torch.inference_mode():
        heads.decode_all([torch.from_numpy(m) for m in maps], port_mini_spec(), 64)
    xs = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    total, _ = yolo_loss(xs, port_mini_spec(), 64, torch.from_numpy(t), torch.from_numpy(mask))
    total.backward()
    assert all(torch.isfinite(x.grad).all() for x in xs)
