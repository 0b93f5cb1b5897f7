"""The plain reference against the port, on the CPU at small sizes: the
port's ``Detector(device="cpu", compute_dtype=torch.float32)`` and its
float32 training step must agree with it to float32 rounding."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, compare, spec, traffic, weights
from benchmark.reference import cfg as ref_cfg
from benchmark.reference.detect import detect as ref_detect, nms_tile
from benchmark.reference.model import forward
from benchmark.reference.train import resize
from benchmark.tests import mini


@pytest.mark.parametrize("path,size", [(mini.CFG, 64),
                                       (None, 64)])
def test_reference_matches_the_f32_detector(path, size):
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    path = path or spec.config("yolov3-amyloid-416")["cfg_path"]
    _, layers = ref_cfg.layers(path)
    yolos = [l for l in layers if l["type"] == "yolo"]
    sd = weights.reference_scheme(layers, traffic.generator(11, "weights", "cpu"), "cpu")
    tiles = torch.randint(0, 256, (3, 2 * size, 2 * size, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    x = resize(tiles, size).permute(0, 3, 1, 2).contiguous()
    heads = weights.scale_heads(sd, layers, x, 0.5)
    weights.objectness_shift(sd, layers, heads, 0.02, 0.8)
    det = Detector(spec=from_cfg(path), params=sd, device="cpu", compute_dtype=torch.float32,
                   model_size=size, tile_size=2 * size, capacity=64)
    dets, valid = det(tiles)
    program = [(d[v].numpy(), int(n)) for d, v, n in zip(dets, valid, det._last_ncand)]
    with torch.no_grad():
        reference = ref_detect(forward(sd, layers, x), yolos, size, 2 * size, 0.8, 0.4, 64)
    numbers, diag = compare.detect_numbers(program, reference, 0.8)
    assert sum(n for _, n in program) > 0
    assert numbers["conf_gap"] < 1e-4 and numbers["miss_margin"] == 0.0
    assert diag["cand_gap"] == 0.0 and diag["keeper_miss"] == 0.0


def test_nms_tile_merges_same_class_overlaps():
    rows = np.array([[10, 10, 4, 4, 0.9, 0.8, 0.1],
                     [11, 10, 4, 4, 0.85, 0.7, 0.2],
                     [11, 10, 4, 4, 0.95, 0.1, 0.9],   # another class: kept apart
                     [40, 40, 4, 4, 0.5, 0.9, 0.1]], np.float32)   # under the threshold
    keep, n = nms_tile(rows, 0.8, 0.4, 64)
    assert n == 3 and len(keep) == 2
    first = keep[keep[:, 6] == 0][0]
    assert first[4] == pytest.approx(0.9) and first[0] == pytest.approx((8 * 0.9 + 9 * 0.85) / 1.75)


def test_reference_step_matches_the_ports_f32_step():
    c, cfg = mini.train_cell()
    out = cell.run_cell(mini.Opts(seed=2_147_483_999, seconds=0.2), torch.device("cpu"),
                        time.perf_counter(), cell=c, config=cfg)
    assert out["info"]["losses_program"] == pytest.approx(out["info"]["losses_reference"],
                                                           rel=1e-5)
    assert out["numbers"]["grad_gap"] < 1e-4 and out["numbers"]["stats_gap"] < 1e-4
