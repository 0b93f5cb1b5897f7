"""YOLOv4 trained through the port's step, on the CPU: the CIoU box term
(``ops/loss.py:ciou``) on closed forms and in a float64 gradcheck,
darknet's targets (``ops/targets.py``, ``iou_thresh`` < 1) on hand-built
truths and against the plain reference's (``benchmark/reference/
yolov4_train.py``), YOLOv3's targets and loss bit for bit what they were
before YOLOv4's keys came in, the cfg's training keys through
``from_cfg``/``emit_cfg``, a small YOLOv4-shaped graph (``mini_v4_train.cfg``)
through ``make_accum_train_step`` against the reference's ``Trainer`` over
three micro-steps, the ``Trainer`` and ``cli train`` on the frozen YOLOv4
cfg, and the ``train/targets`` span and ``loss.ciou_heads`` counter."""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from amyloid_yolo_tpu_torch.graphspec import YoloSpec, emit_cfg, from_cfg
from amyloid_yolo_tpu_torch.models.heads import head_grid_tensors
from amyloid_yolo_tpu_torch.ops import loss as loss_mod
from amyloid_yolo_tpu_torch.ops.boxes import bbox_iou, bbox_wh_iou, xywh2xyxy
from amyloid_yolo_tpu_torch.ops.targets import _assemble_scatter, build_targets
from amyloid_yolo_tpu_torch.parallel import steps
from amyloid_yolo_tpu_torch.utils import spans
from benchmark.harness import traffic, weights
from benchmark.reference import yolov4_train as ref
from benchmark.reference.draws import draw_augment_params

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MINI_CFG = os.path.join(REPO, "benchmark", "tests", "mini_v4_train.cfg")
V4_CFG = os.path.join(REPO, "benchmark", "configs", "yolov4-amyloid-608.cfg")
V3_CFG = os.path.join(REPO, "benchmark", "configs", "yolov3-amyloid-512a.cfg")


def _heads(spec):
    return [l for l in spec.layers if isinstance(l, YoloSpec)]


# ---------------------------------------------------------------------------
# CIoU


def _terms(p, t):
    """The paper's pieces in float64 from the test's own arithmetic:
    ``(IoU, ρ²/c², v, α)``."""
    p1, p2 = p[..., :2] - p[..., 2:] / 2, p[..., :2] + p[..., 2:] / 2
    t1, t2 = t[..., :2] - t[..., 2:] / 2, t[..., :2] + t[..., 2:] / 2
    wh = (torch.minimum(p2, t2) - torch.maximum(p1, t1)).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (p[..., 2] * p[..., 3] + t[..., 2] * t[..., 3] - inter)
    c = torch.maximum(p2, t2) - torch.minimum(p1, t1)
    d = ((p[..., :2] - t[..., :2]) ** 2).sum(-1) / (c ** 2).sum(-1)
    v = 4 / math.pi ** 2 * (torch.atan(t[..., 2] / t[..., 3])
                            - torch.atan(p[..., 2] / p[..., 3])) ** 2
    return iou, d, v, v / ((1 - iou) + v)


CLOSED = {  # (pred, truth, CIoU)
    "equal": ((1.0, 2.0, 3.0, 4.0), (1.0, 2.0, 3.0, 4.0), 1.0),
    "nested": ((0.0, 0.0, 2.0, 2.0), (0.0, 0.0, 1.0, 1.0), 0.25),
    "disjoint": ((0.0, 0.0, 1.0, 1.0), (3.0, 0.0, 1.0, 1.0), -9.0 / 17.0),
    "shaped": ((0.0, 0.0, 2.0, 1.0), (0.0, 0.0, 1.0, 2.0),
               1 / 3 - (lambda v: v * v / (2 / 3 + v))(
                   4 / math.pi ** 2 * (math.atan(0.5) - math.atan(2.0)) ** 2)),
}


@pytest.mark.parametrize("case", sorted(CLOSED))
def test_ciou_closed_forms(case):
    """Equal boxes 1; a box inside one twice its side, same centre, IoU
    1/4; disjoint unit boxes 3 apart, −ρ²/c² = −9/17; a 2×1 against a
    1×2, IoU 1/3 less α·v.  The program's and the reference's."""
    p, t, want = CLOSED[case]
    p64, t64 = torch.tensor([p], dtype=torch.float64), torch.tensor([t], dtype=torch.float64)
    for fn in (loss_mod.ciou, ref.ciou):
        assert float(fn(p64, t64)[0]) == pytest.approx(want, abs=1e-8)
        got32 = float(fn(p64.float(), t64.float())[0])
        assert got32 == pytest.approx(want, abs=1e-6)


def test_ciou_gradcheck_with_alpha_held():
    """``α`` carries no gradient: the program's CIoU plus ``α·v`` with
    ``α`` detached, less ``α·v`` with it live, is the full CIoU as a
    function, and its backward is the full CIoU's only if the program's
    takes ``α`` as a constant."""
    g = torch.Generator().manual_seed(0)
    t = torch.cat([torch.rand(6, 2, generator=g, dtype=torch.float64),
                   0.5 + torch.rand(6, 2, generator=g, dtype=torch.float64)], -1)
    p = t + 0.3 * torch.randn(6, 4, generator=g, dtype=torch.float64)
    p[:, 2:] = p[:, 2:].abs() + 0.2
    p.requires_grad_(True)

    def full(q):
        _, _, v, alpha = _terms(q, t)
        return loss_mod.ciou(q, t) + alpha.detach() * v - alpha * v

    assert torch.autograd.gradcheck(full, (p,), eps=1e-6, atol=1e-7)
    # and α does move: the gradient with it live differs
    iou, d, v, alpha = _terms(p, t)
    live = torch.autograd.grad((iou - d - alpha * v).sum(), p)[0]
    held = torch.autograd.grad(loss_mod.ciou(p, t).sum(), p)[0]
    assert (live - held).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# targets


def _v4_spec(**changes):
    spec = from_cfg(MINI_CFG)
    layers = tuple(dataclasses.replace(l, **changes) if isinstance(l, YoloSpec) else l
                   for l in spec.layers)
    return dataclasses.replace(spec, layers=layers)


def _targets(spec, truths, size=64, b=1, seed=0):
    """Each head's targets for the (T, 6) normalized ``truths``, on random
    head maps of the right shapes."""
    g = torch.Generator().manual_seed(seed)
    t = torch.tensor(truths, dtype=torch.float32)
    out = []
    for ys, side in zip(_heads(spec), (size // 2, size // 4)):
        raw = torch.randn(b, side, side, 3 * (5 + ys.num_classes), generator=g)
        tt = head_grid_tensors(raw, ys.anchors, size, ys.num_classes, ys.scale_x_y)
        kw = {}
        if ys.iou_thresh < 1:
            kw = dict(iou_thresh=ys.iou_thresh, mask=ys.mask,
                      all_anchors=torch.tensor(ys.all_anchors) / tt["stride"])
        ok = torch.ones(len(t), dtype=torch.bool)
        out.append(build_targets(tt["pred_boxes"], tt["cls"], t, ok, tt["scaled_anchors"],
                                 ys.ignore_thres, boxes=True, **kw))
    return out


def _positives(bt):
    return [tuple(int(v) for v in ix) for ix in bt["obj_mask"].nonzero()]


# a 24×18 px truth at 64²: its best of the six anchors is (24, 18), the
# second head's; the first head's (12, 9) lies at width-height IoU 0.25
# above 0.213, its (4, 6) and (8, 10) under it; on the second head (14, 20)
# reads 0.548 and (30, 34) 0.424
TRUTH = [[0, 1, 0.3, 0.6, 24 / 64, 18 / 64]]


def test_a_truth_whose_best_lies_on_another_head_gives_its_thresh_positives():
    h1, h2 = _targets(_v4_spec(), TRUTH)
    cell1, cell2 = (19, 9), (9, 4)      # (row, col) at strides 2 and 4
    assert _positives(h1) == [(0, 2, *cell1)]
    assert _positives(h2) == [(0, 0, *cell2), (0, 1, *cell2), (0, 2, *cell2)]
    # the truth box in grid units, the class, noobj off at every positive
    np.testing.assert_allclose(h1["tbox"][0, 2, 19, 9].numpy(),
                               [0.3 * 32, 0.6 * 32, 24 / 2, 18 / 2], rtol=1e-6)
    assert h2["tcls"][0, 1, 9, 4].tolist() == [0.0, 1.0]
    assert not h1["noobj_mask"][0, 2, 19, 9] and not h2["noobj_mask"][0, :, 9, 4].any()
    np.testing.assert_allclose(float(h2["tw"][0, 1, 9, 4]), math.log(24 / 24), atol=1e-6)


def test_iou_thresh_one_gives_the_best_only_set():
    """``iou_thresh`` 1: one positive a head, its own best (YOLOv3's rule);
    just under 1: darknet's best of the whole table alone."""
    h1, h2 = _targets(_v4_spec(iou_thresh=1.0), TRUTH)
    assert _positives(h1) == [(0, 2, 19, 9)] and _positives(h2) == [(0, 1, 9, 4)]
    h1, h2 = _targets(_v4_spec(iou_thresh=math.nextafter(1.0, 0.0)), TRUTH)
    assert _positives(h1) == [] and _positives(h2) == [(0, 1, 9, 4)]


def test_two_truths_on_one_cell_and_anchor_keep_the_later_row():
    """The later row's values, both rows' classes, as YOLOv3's rule keeps
    them; the reference keeps the same."""
    truths = [[0, 0, 0.3, 0.6, 20 / 64, 16 / 64], [0, 1, 0.31, 0.61, 26 / 64, 19 / 64]]
    h1, h2 = _targets(_v4_spec(), truths)
    assert (0, 1, 9, 4) in _positives(h2)
    np.testing.assert_allclose(float(h2["tw"][0, 1, 9, 4]), math.log(26 / 4 / (24 / 4)),
                               rtol=1e-5)
    assert h2["tcls"][0, 1, 9, 4].tolist() == [1.0, 1.0]
    _, layers = ref.layers(MINI_CFG)
    yolo = [l for l in layers if l["type"] == "yolo"][1]
    want = ref.assign(torch.tensor(truths), torch.ones(2, dtype=torch.bool), yolo, 4.0, 16, 1)
    assert torch.equal(want["obj"], h2["obj_mask"])
    assert torch.equal(want["noobj"], h2["noobj_mask"])
    assert torch.equal(want["tcls"], h2["tcls"])
    np.testing.assert_allclose(want["tw"].numpy(), h2["tw"].numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_targets_match_the_reference_on_random_truths(seed):
    r = np.random.RandomState(seed)
    n = 24
    truths = np.zeros((n + 4, 6), np.float32)
    truths[:, 0] = r.randint(0, 3, n + 4)
    truths[:, 1] = r.randint(0, 2, n + 4)
    truths[:, 2:4] = r.rand(n + 4, 2)
    truths[:, 4:6] = 0.05 + 0.45 * r.rand(n + 4, 2)
    truths[n + 1, 2:4] = truths[n, 2:4]           # a shared centre
    valid = np.ones(n + 4, bool)
    valid[-2:] = False                            # padding rows
    spec = _v4_spec()
    g = torch.Generator().manual_seed(seed)
    _, layers = ref.layers(MINI_CFG)
    for ys, yolo, side in zip(_heads(spec), [l for l in layers if l["type"] == "yolo"],
                              (32, 16)):
        raw = torch.randn(3, side, side, 21, generator=g)
        tt = head_grid_tensors(raw, ys.anchors, 64, 2, ys.scale_x_y)
        got = build_targets(tt["pred_boxes"], tt["cls"], torch.from_numpy(truths),
                            torch.from_numpy(valid), tt["scaled_anchors"], ys.ignore_thres,
                            iou_thresh=ys.iou_thresh, mask=ys.mask, boxes=True,
                            all_anchors=torch.tensor(ys.all_anchors) / tt["stride"])
        want = ref.assign(torch.from_numpy(truths), torch.from_numpy(valid), yolo,
                          64 / side, side, 3)
        for a, b in (("obj", "obj_mask"), ("noobj", "noobj_mask"), ("tcls", "tcls")):
            assert torch.equal(want[a], got[b]), a
        for a in ("tx", "ty", "tw", "th"):
            np.testing.assert_allclose(got[a].numpy(), want[a].numpy(), atol=2e-6, err_msg=a)
        np.testing.assert_allclose(got["tbox"].numpy(), want["box"].numpy(), atol=2e-6)
        assert int(got["obj_mask"].sum()) > n // 2


# YOLOv3's targets and head loss as they were before YOLOv4's keys came in
# (ops/targets.py:build_targets, ops/loss.py:yolo_head_loss), kept here to
# hold the YOLOv3 path to them bit for bit


def _targets_before(pred_boxes, pred_cls, target, target_mask, anchors, ignore_thres):
    nB, nA, nG = pred_boxes.shape[0], pred_boxes.shape[1], pred_boxes.shape[2]
    nC = pred_cls.shape[-1]
    nT = target.shape[0]
    shape = (nB, nA, nG, nG)
    target = target.to(torch.float32)
    b = target[:, 0].long()
    valid = target_mask.bool() & (b >= 0) & (b < nB)
    labels = target[:, 1].long()
    gxy = target[:, 2:4] * nG
    gwh = target[:, 4:6] * nG
    gx, gy = gxy[:, 0], gxy[:, 1]
    gw, gh = gwh[:, 0], gwh[:, 1]
    gi = gx.long().clamp(0, nG - 1)
    gj = gy.long().clamp(0, nG - 1)
    ious = bbox_wh_iou(anchors, gwh)
    best_n = torch.argmax(ious, dim=0)
    tx_v = gx - torch.floor(gx)
    ty_v = gy - torch.floor(gy)
    tw_v = torch.log(gw / anchors[best_n, 0] + 1e-16)
    th_v = torch.log(gh / anchors[best_n, 1] + 1e-16)
    bc = b.clamp(0, nB - 1)
    pred_at = pred_boxes[bc, best_n, gj, gi]
    pred_cls_at = pred_cls[bc, best_n, gj, gi]
    iou_vals = bbox_iou(xywh2xyxy(pred_at), xywh2xyxy(torch.stack([gx, gy, gw, gh], dim=-1)))
    cls_ok = (torch.argmax(pred_cls_at, dim=-1) == labels).to(torch.float32)
    ncell = nB * nA * nG * nG
    key = torch.where(valid, ((bc * nA + best_n) * nG + gj) * nG + gi, ncell)
    a_ids = torch.arange(nA)[:, None]
    key_ign = ((bc[None, :] * nA + a_ids) * nG + gj[None, :]) * nG + gi[None, :]
    key_ign = torch.where((ious > ignore_thres) & valid[None, :], key_ign, ncell).reshape(-1)
    values = torch.stack([tx_v, ty_v, tw_v, th_v, iou_vals, cls_ok], dim=-1)
    obj, noobj, vals, tcls = _assemble_scatter(ncell, nC, key, key_ign, torch.arange(nT), valid,
                                               labels.clamp(0, nC - 1), values)
    vals = vals.reshape(*shape, 6)
    obj_mask = obj.reshape(shape)
    return {"iou_scores": vals[..., 4], "class_mask": vals[..., 5], "obj_mask": obj_mask,
            "noobj_mask": noobj.reshape(shape), "tx": vals[..., 0], "ty": vals[..., 1],
            "tw": vals[..., 2], "th": vals[..., 3], "tcls": tcls.reshape(*shape, nC),
            "tconf": obj_mask.to(torch.float32)}


def _head_loss_before(raw, yolo, img_dim, target, target_mask):
    mm, bce = loss_mod._masked_mean, loss_mod._bce
    t = head_grid_tensors(raw, yolo.anchors, img_dim, yolo.num_classes, yolo.scale_x_y)
    bt = _targets_before(t["pred_boxes"].detach(), t["cls"].detach(), target, target_mask,
                         t["scaled_anchors"], yolo.ignore_thres)
    obj, noobj = bt["obj_mask"].to(torch.float32), bt["noobj_mask"].to(torch.float32)
    terms = {"x": mm((t["x"] - bt["tx"]) ** 2, obj), "y": mm((t["y"] - bt["ty"]) ** 2, obj),
             "w": mm((t["w"] - bt["tw"]) ** 2, obj), "h": mm((t["h"] - bt["th"]) ** 2, obj)}
    b = bce(t["conf"], bt["tconf"])
    terms["conf"] = (yolo.obj_scale * mm(b, obj) + yolo.noobj_scale * mm(b, noobj))
    terms["cls"] = mm(bce(t["cls"], bt["tcls"]).sum(dim=-1) / t["cls"].shape[-1], obj)
    total = terms["x"] + terms["y"] + terms["w"] + terms["h"] + terms["conf"] + terms["cls"]
    return total, bt, terms


@pytest.mark.parametrize("seed", [0, 1])
def test_yolov3_targets_and_loss_are_bit_for_bit_what_they_were(seed):
    spec = from_cfg(V3_CFG)
    r = np.random.RandomState(seed)
    truths = np.zeros((40, 6), np.float32)
    truths[:, 0] = r.randint(0, 2, 40)
    truths[:, 1] = r.randint(0, 2, 40)
    truths[:, 2:4] = r.rand(40, 2)
    truths[:, 4:6] = 0.02 + 0.3 * r.rand(40, 2)
    truths[7] = truths[3]
    t, m = torch.from_numpy(truths), torch.from_numpy(r.rand(40) > 0.1)
    g = torch.Generator().manual_seed(seed)
    for ys, side in zip(_heads(spec), (16, 32, 64)):
        assert ys.iou_loss == "mse" and ys.iou_thresh == 1.0 and ys.cls_normalizer == 1.0
        raw = torch.randn(2, side, side, 21, generator=g, requires_grad=True)
        tt = head_grid_tensors(raw, ys.anchors, 512, 2)
        want = _targets_before(tt["pred_boxes"].detach(), tt["cls"].detach(), t, m,
                               tt["scaled_anchors"], ys.ignore_thres)
        got = build_targets(tt["pred_boxes"], tt["cls"], t, m, tt["scaled_anchors"],
                            ys.ignore_thres)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        before = loss_mod.ciou_heads
        total, metrics = loss_mod.yolo_head_loss(raw, ys, 512, t, m)
        assert loss_mod.ciou_heads == before
        want_total, _, terms = _head_loss_before(raw, ys, 512, t, m)
        assert torch.equal(total, want_total)
        assert all(torch.equal(metrics[k], terms[k]) for k in terms)
        g_new = torch.autograd.grad(total, raw)[0]
        g_old = torch.autograd.grad(_head_loss_before(raw, ys, 512, t, m)[0], raw)[0]
        assert torch.equal(g_new, g_old)


# ---------------------------------------------------------------------------
# the cfg's keys


def test_from_cfg_reads_and_emit_cfg_writes_the_training_keys(tmp_path):
    spec = from_cfg(V4_CFG)
    heads = _heads(spec)
    assert [h.iou_loss for h in heads] == ["ciou"] * 3
    assert [(h.iou_normalizer, h.cls_normalizer, h.iou_thresh, h.ignore_thres)
            for h in heads] == [(0.07, 1.0, 0.213, 0.5)] * 3
    assert [h.mask for h in heads] == [(0, 1, 2), (3, 4, 5), (6, 7, 8)]
    assert all(len(h.all_anchors) == 9 and h.all_anchors[8] == (459, 401) for h in heads)
    path = tmp_path / "again.cfg"
    path.write_text(emit_cfg(spec))
    assert from_cfg(str(path)) == spec
    mini = from_cfg(MINI_CFG)
    path.write_text(emit_cfg(mini))
    assert from_cfg(str(path)) == mini
    assert [h.cls_normalizer for h in _heads(mini)] == [1.0, 0.5]


def test_a_cfg_without_the_keys_gets_yolov3s_loss():
    for h in _heads(from_cfg(V3_CFG)):
        assert (h.iou_loss, h.iou_normalizer, h.cls_normalizer, h.iou_thresh,
                h.ignore_thres) == ("mse", 1.0, 1.0, 1.0, 0.5)


def test_an_unknown_iou_loss_raises(tmp_path):
    path = tmp_path / "giou.cfg"
    path.write_text(open(MINI_CFG).read().replace("iou_loss=ciou", "iou_loss=giou", 1))
    with pytest.raises(ValueError, match="unsupported iou_loss 'giou'"):
        from_cfg(str(path))
    with pytest.raises(ValueError, match="iou_loss 'giou' is not in the reference"):
        ref.layers(str(path))


# ---------------------------------------------------------------------------
# the step against the reference


def _batch(seed, b=2, side=96, n=4):
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (b, side, side, 3), dtype=torch.uint8, generator=g)
    t = torch.zeros(b * n, 6)
    t[:, 0] = torch.arange(b).repeat_interleave(n).float()
    t[:, 1] = torch.randint(0, 2, (b * n,), generator=g).float()
    wh = 0.1 + 0.3 * torch.rand(b * n, 2, generator=g)
    t[:, 2:4] = wh / 2 + (1 - wh) * torch.rand(b * n, 2, generator=g)
    t[:, 4:6] = wh
    mask = torch.ones(b * n, dtype=torch.bool)
    mask[-1] = False
    return images, t, mask


def test_the_step_trains_the_mini_yolov4_as_the_reference_does():
    """Three micro-steps at 64², B=2, accumulation 2 (applies at the first
    and the third), augment on, through ``make_accum_train_step`` and the
    reference's ``Trainer``.  Both are float32 on the CPU in other orders
    of summation (the port's BN takes ``E[x²] − mean²`` in one pass, the
    reference ``var_mean``; NHWC against NCHW maps; the loss's means as
    masked sums against gathers).  The first gradient, as Adam's first
    moment took it, agrees to 1e-4 of each leaf's norm (read 1.5e-5).
    Adam's steps, near ``lr·sign(g)`` element by element, turn a rounding
    of a gradient near 0 into a whole step of the other sign, and the
    micro-steps after an apply start from parameters that differ so: the
    losses agree to 1e-5 of their value and each head's box term to 1e-4
    all the same, the BN running statistics to 1e-4 of their scale, and the
    parameters' change over the three steps leaf by leaf to 5% of its norm
    (read 1.1%; ``change_gap``'s limit in the train cells is far wider for
    this reason)."""
    _, layers = ref.layers(MINI_CFG)
    sd = weights.reference_scheme(layers, traffic.generator(3, "weights", "cpu"), "cpu")
    spec = from_cfg(MINI_CFG)
    opt = steps.make_optimizer(1e-3)
    state = steps.init_train_state(sd, opt, device="cpu")
    astate = steps.init_accum_state(state)
    step = steps.make_accum_train_step(spec, opt, 2, augment=True)
    trainer = ref.Trainer(sd, layers, 1e-3)
    g_prog = torch.Generator().manual_seed(9)
    g_ref = torch.Generator().manual_seed(9)
    keys = trainer.keys
    b1 = state.optimizer.param_groups[0]["betas"][0]
    for k in range(3):
        images, t, mask = _batch(k)
        before = loss_mod.ciou_heads
        astate, metrics = step(astate, images, t, mask, g_prog, 64)
        assert loss_mod.ciou_heads == before + 2
        draws = draw_augment_params(g_ref, 2, 64, "cpu")
        want, grads = trainer.micro(images, t, mask, draws, 64, apply=k % 2 == 0)
        assert float(metrics["loss"]) == pytest.approx(float(want), rel=1e-5)
        for h in range(2):
            assert float(metrics[f"head{h}/iou"]) == pytest.approx(
                float(trainer.box_terms[h]), rel=1e-4, abs=1e-7)
        assert sum(trainer.head_positives) > 4
        if k > 0:
            continue
        for key in keys:   # the first gradient, as Adam's first moment took it
            got = state.optimizer.state[state.params[key]]["exp_avg"] / (1 - b1)
            scale = max(float(grads[key].norm()), 1e-12)
            assert float((got - grads[key]).norm()) <= 1e-4 * scale, key
    with torch.no_grad():
        for key in keys:
            moved = float((trainer.p[key] - sd[key]).norm())
            assert float((state.params[key] - sd[key]).norm()) == pytest.approx(
                moved, rel=5e-2), key
        for key in [k for k in sd if k.endswith(("running_mean", "running_var"))]:
            want = trainer.p[key]
            np.testing.assert_allclose(state.params[key].numpy(), want.numpy(),
                                       atol=1e-4 * max(1.0, float(want.abs().max())),
                                       err_msg=key)


# ---------------------------------------------------------------------------
# the Trainer, the CLI and the span


def _data_config(tmp_path, n_images=0):
    from PIL import Image
    paths = []
    (tmp_path / "images").mkdir(exist_ok=True)
    (tmp_path / "labels").mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n_images):
        p = tmp_path / "images" / f"t{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (96, 96, 3)).astype(np.uint8)).save(p)
        (tmp_path / "labels" / f"t{i}.txt").write_text("1 0.5 0.5 0.3 0.2\n0 0.3 0.3 0.2 0.2\n")
        paths.append(str(p))
    (tmp_path / "train.txt").write_text("".join(p + "\n" for p in paths))
    (tmp_path / "names").write_text("CAA\nCored\n")
    cfg = tmp_path / "custom.data"
    cfg.write_text(f"classes=2\ntrain={tmp_path / 'train.txt'}\n"
                   f"valid={tmp_path / 'train.txt'}\nnames={tmp_path / 'names'}\n")
    return str(cfg)


def test_the_trainer_takes_the_frozen_yolov4_cfg_on_the_plain_stem(tmp_path, monkeypatch):
    from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = dict(data_config=_data_config(tmp_path), logdir=str(tmp_path / "logs"))
    spec = from_cfg(V4_CFG)
    tr = Trainer(TrainConfig(**cfg), spec=spec, device="cpu")
    assert tr.s2d_stem is False and tr.spec is spec
    with pytest.raises(ValueError, match="the s2d stem takes YOLOv3's"):
        Trainer(TrainConfig(s2d_stem=True, **cfg), spec=spec, device="cpu")


def test_cli_train_trains_the_mini_yolov4(tmp_path, monkeypatch):
    """``cli train --model_def`` a YOLOv4 cfg: one micro-step, its
    checkpoint; the loss is the CIoU heads' (the counter moves)."""
    from amyloid_yolo_tpu_torch.cli import main as cli
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    before = loss_mod.ciou_heads
    argv = ["train", "--model_def", MINI_CFG, "--data_config", _data_config(tmp_path, 2),
            "--epochs", "1", "--batch_size", "2", "--img_size", "64",
            "--multiscale_training", "False", "--max_batches_per_epoch", "1",
            "--checkpoint_dir", str(tmp_path / "ck"), "--logdir", str(tmp_path / "logs"),
            "--gradient_accumulations", "1", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert loss_mod.ciou_heads == before + 2
    ck = torch.load(tmp_path / "ck" / "yolov3_ckpt_0.pt", weights_only=True)
    assert (ck["step"], ck["seen"]) == (1, 2)


def test_train_targets_lies_inside_train_loss_for_each_head():
    _, layers = ref.layers(MINI_CFG)
    sd = weights.reference_scheme(layers, traffic.generator(4, "weights", "cpu"), "cpu")
    opt = steps.make_optimizer(1e-3)
    state = steps.init_train_state(sd, opt, device="cpu")
    step = steps.make_train_step(from_cfg(MINI_CFG), opt, augment=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *_batch(5), None, 64)
    rows = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name in (spans.TRAIN_LOSS, spans.TRAIN_TARGETS))
    loss = [r for r in rows if r[2] == spans.TRAIN_LOSS]
    inner = [r for r in rows if r[2] == spans.TRAIN_TARGETS]
    assert len(loss) == 1 and len(inner) == 2
    assert all(loss[0][0] <= a and b <= loss[0][1] for a, b, _ in inner)
