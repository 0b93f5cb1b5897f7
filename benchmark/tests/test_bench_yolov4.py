"""The ``detect_v4`` kind, YOLOv4's reference and its two readers, on the
CPU: the reference against the port's float32 ``Detector`` on the mini
YOLOv4, the kind's ``centre_bias`` on made-up keepers, whole runs of the
kind at test size (a sound program correct, the two new faults not), its
pool-safe keepers on made-up tiles, and ``mish_roofline.detect``,
``leaky_roofline.detect`` and ``mish_launches_per_batch.detect`` on
synthetic contexts."""

import json

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import compare, flops, spec, traffic, weights
from benchmark.harness.kind_detect_v4 import ROW_GAP, centre_bias, pooled_keepers, scale_heads
from benchmark.reference import cfg as ref_cfg, yolov4 as ref
from benchmark.reference.train import resize
from benchmark.tests import mini, mini_v4

NAME = "void (anonymous namespace)::bias_mish_kernel<true, unsigned int>(unsigned short*, ...)"
LEAKY = "void (anonymous namespace)::bias_leaky_kernel<true, unsigned int>(unsigned short*, ...)"


def test_reference_matches_the_f32_detector():
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    _, layers = ref.layers(mini_v4.CFG)
    yolos = [l for l in layers if l["type"] == "yolo"]
    sd = weights.reference_scheme(layers, traffic.generator(11, "weights", "cpu"), "cpu")
    tiles = torch.randint(0, 256, (3, 128, 128, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    x = resize(tiles, 64).permute(0, 3, 1, 2).contiguous()
    heads = scale_heads(sd, layers, x, 0.5)
    weights.objectness_shift(sd, layers, heads, 0.02, 0.8)
    det = Detector(spec=from_cfg(mini_v4.CFG), params=sd, device="cpu",
                   compute_dtype=torch.float32, model_size=64, tile_size=128, capacity=64)
    dets, valid = det(tiles)
    program = [(d[v].numpy(), int(n)) for d, v, n in zip(dets, valid, det._last_ncand)]
    with torch.no_grad():
        reference = ref.detect(ref.forward(sd, layers, x), yolos, 64, 128, 0.8, 0.4, 64)
    numbers, diag = compare.detect_numbers(program, reference, 0.8)
    assert sum(n for _, n in program) > 0
    assert numbers["conf_gap"] < 1e-4 and numbers["miss_margin"] == 0.0
    assert numbers["box_gap"] < 1e-5
    assert diag["cand_gap"] == 0.0 and diag["keeper_miss"] == 0.0


def test_the_reference_refuses_an_unknown_activation(tmp_path):
    path = tmp_path / "swish.cfg"
    path.write_text(open(mini_v4.CFG).read().replace("activation=mish", "activation=swish", 1))
    with pytest.raises(ValueError, match="activation 'swish' is not in the reference"):
        ref.layers(str(path))


@pytest.mark.parametrize("inward", [0.0, 0.25])
def test_centre_bias_is_the_share_of_the_stretch_left_out(inward):
    """One head at stride 8 with s = 1.2 (the stretch is 1.6 model pixels),
    model 64 and tile 128: keepers in both halves of their cells, the
    program's moved toward their cells' middles by ``inward`` of the stretch
    (tile pixels: × 2), read back as ``inward``."""
    layers = [{"type": "conv", "cin": 3, "cout": 21, "k": 1, "stride": 8},
              {"type": "yolo", "anchors": [(8, 8)] * 3, "classes": 2, "scale_x_y": 1.2,
               "cout": 21}]
    rows = np.zeros((3 * 8 * 8, 7), np.float32)
    centres = np.array([[2.0, 3.0], [13.0, 14.0], [37.5 + 1.0, 50.0], [22.0, 45.0]])
    for k, (cx, cy) in enumerate(centres):   # in model pixels; rows in tile pixels
        rows[k, 0:4] = 2 * np.array([cx - 4, cy - 4, cx + 4, cy + 4])
        rows[k, 4] = 0.81 + 0.01 * k
    ref_keep = np.concatenate([rows[:4, :5], np.full((4, 1), 0.9), np.zeros((4, 1))], axis=1)
    side = np.sign(np.mod(centres / 8, 1.0) - 0.5)
    prog = ref_keep.copy()
    prog[:, 0:4] -= np.tile(2 * inward * 1.6 * side, 2)
    got = centre_bias([(prog, 4)], [(ref_keep, 4, rows)], layers, 64, 128)
    assert got == pytest.approx(inward, abs=1e-6)


def _tile(scores, keeper_scores):
    """One tile's reference: rows of objectness 0.9 and class probability
    ``score / 0.9`` (two classes), and keepers carrying their scores."""
    rows = np.zeros((len(scores), 7), np.float32)
    rows[:, 4], rows[:, 5] = 0.9, np.asarray(scores) / 0.9
    keep = np.zeros((len(keeper_scores), 7), np.float32)
    keep[:, 4], keep[:, 5] = 0.9, np.asarray(keeper_scores) / 0.9
    return keep, len(scores), rows


@pytest.mark.parametrize("n_rows, n_program, keepers, kept", [
    (4, 4, [0.9, 0.8, 0.75], 3),    # both pools of 4 hold every candidate
    (6, 4, [0.9, 0.8, 0.75], 2),    # the cut is the fifth row's 0.7: 0.75 lies within 4 · 0.02
    (4, 6, [0.9, 0.8, 0.75], 2),    # the program's pool overflowed: the same cut
    (6, 6, [0.9, 0.8, 0.785], 3)])
def test_pooled_keepers_leave_out_the_keepers_near_the_pools_cut(n_rows, n_program, keepers,
                                                                  kept):
    scores = [0.9, 0.85, 0.8, 0.75, 0.7, 0.69]
    tile = _tile(scores, keepers)
    tile = (tile[0], n_rows, tile[2])
    (keep, n, rows), = pooled_keepers([(None, n_program)], [tile], 4, 0.8)
    assert ROW_GAP == 0.02 and len(keep) == kept and n == n_rows and len(rows) == 6
    # rows under the threshold by more than ROW_GAP are no candidates of either side
    tile[2][4:, 4] = 0.8 - 2 * ROW_GAP
    assert len(pooled_keepers([(None, n_program)], [tile], 4, 0.8)[0][0]) == 3


def _run(capsys, variant=None):
    cell, cfg = mini_v4.detect_cell(limits=spec.workload("detect-v4-608-b64")["limits"])
    rc = run.report(mini.Opts(seed=2_147_483_647 + 12345, seconds=0.3), torch.device("cpu"),
                    cell_dict=cell, config=cfg, variant=variant)
    out, _ = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    rc, line = _run(capsys)
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0
    assert set(line["checks"]) == {"conf_gap", "miss_margin", "box_gap", "cand_gap",
                                   "centre_bias"}
    assert line["metrics"]["setup_s"]["unit"] == "s"


@pytest.mark.parametrize("fault", ["mish_as_silu", "unscaled_xy"])
def test_a_planted_fault_is_not_correct(capsys, fault):
    rc, line = _run(capsys, fault)
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _ctx(by_name, mish_launches=None, batch=64, calls=8):
    _, layers = ref.layers(spec.config("yolov4-amyloid-608")["cfg_path"])
    ctx = {"kind": "detect", "trace": {"by_name": by_name, "device": [("k", 0.0, 1.0)]},
           "steps_traced": calls, "layers": layers, "model_size": 608, "batch": batch}
    if mish_launches is not None:
        ctx["mish_launches"] = mish_launches
    return ctx


@pytest.mark.parametrize("by_name", [{}, {"void at::native::vectorized_elementwise_kernel": 0.06},
                                     {"void (anonymous namespace)::bias_leaky_kernel<true>": 0.08}])
def test_the_readers_find_nothing_without_the_kernel_or_the_counter(by_name):
    assert spec.reader("mish_roofline.detect")(_ctx(by_name)) is None
    assert spec.reader("mish_launches_per_batch.detect")(_ctx(by_name)) is None
    if not any("bias_leaky" in n for n in by_name):
        assert spec.reader("leaky_roofline.detect")(_ctx(by_name)) is None


def test_leaky_roofline_is_the_bound_over_the_leaky_kernels_time_a_call():
    read = spec.reader("leaky_roofline.detect")
    # the 35 leaky convs and 3 linear heads write 17,810,657 elements an
    # image at 608: at B=64, 4.56 GB read and written in bf16, 1.36 ms
    bound = 4 * 64 * 17_810_657 / flops.PEAKS["hbm_bytes_per_s"]
    ctx = _ctx({LEAKY: 8 * bound, LEAKY.replace("true", "false"): 8 * bound, NAME: 1.0})
    assert read(ctx) == pytest.approx(50.0, rel=1e-3)
    assert read({**ctx, "kind": "train"}) is None
    # a graph without Mish convs (YOLOv3) gives nothing: epilogue_roofline reads it
    _, v3 = ref_cfg.layers(spec.config("yolov3-amyloid-416")["cfg_path"])
    assert read({**ctx, "layers": v3, "model_size": 416}) is None


def test_mish_roofline_is_the_bound_over_the_kernels_time_a_call():
    read = spec.reader("mish_roofline.detect")
    # the 72 Mish convs write 94,818,816 elements an image at 608: at B=64,
    # 24.27 GB read and written in bf16, 7.25 ms
    bound = 4 * 64 * 94_818_816 / flops.PEAKS["hbm_bytes_per_s"]
    assert bound == pytest.approx(7.2458e-3, rel=1e-4)
    ctx = _ctx({NAME: 8 * bound, NAME.replace("true", "false"): 8 * bound,
                "void (anonymous namespace)::bias_leaky_kernel<true>": 1.0})
    assert read(ctx) == pytest.approx(50.0)
    assert read({**ctx, "kind": "train"}) is None
    # a graph without Mish convs (YOLOv3) gives nothing
    _, v3 = ref_cfg.layers(spec.config("yolov3-amyloid-416")["cfg_path"])
    assert read({**ctx, "layers": v3, "model_size": 416}) is None


def test_mish_launches_per_call():
    read = spec.reader("mish_launches_per_batch.detect")
    assert read(_ctx({NAME: 1.0}, mish_launches=576)) == 72.0
    assert read({**_ctx({}, mish_launches=576), "kind": "train"}) is None
