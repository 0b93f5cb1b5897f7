"""The ``train_v4`` kind and its reader on the CPU: whole runs at test size
(``mini_v4_train.cfg``, 64²) through ``run.report`` under the cell's
limits, a sound program correct and the planted faults not; the refusal
of a program that would take YOLOv3's loss; ``targets_device_ms.train`` on
synthetic contexts."""

import dataclasses
import json
import os

import pytest
import torch

from benchmark import run
from benchmark.harness import spec
from benchmark.tests import mini

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "mini_v4_train.cfg")


def train_cell(limits=None) -> tuple:
    cfg = {"name": "mini-v4-64-train", "cfg": "mini_v4_train.cfg", "cfg_path": CFG,
           "reduced": [], "img_size": 64,
           "step": {"dtype": "float32", "accum": 2, "learning_rate": 1e-3, "augment": True},
           "control": {"allow_tf32": True}}
    cell = {"name": "train-v4-mini", "config": "mini-v4-64-train", "traffic": "mini-fixed-v4",
            "chips": 1,
            "mix": {"kind": "train_v4", "tile": 96, "batch": 4, "pool_batches": 4,
                    "boxes": [2, 5], "box_size": [0.1, 0.4], "max_objects": 6,
                    "order": [64], "per_size": 2, "warm_per_size": 3, "traced_steps": 2,
                    "traced_size": 64, "unrecorded_per_call": 1},
            "limits": limits or {}}
    return cell, cfg


def _run(capsys, variant=None, trace=0, seed=2_147_483_647 + 777):
    cell, cfg = train_cell(limits=spec.workload("train-v4-608-b8")["limits"])
    rc = run.report(mini.Opts(seed=seed, seconds=0.3, trace=trace), torch.device("cpu"),
                    cell_dict=cell, config=cfg, variant=variant)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def test_a_sound_run_is_correct(capsys):
    rc, line, err = _run(capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap", "stats_gap"}
    assert "setup_s" in line["metrics"]
    info = json.loads(err.split("# info: ", 1)[1].splitlines()[0])
    # the first micro-step's total and its two heads' box terms, on both sides
    assert len(info["losses_program"]) == len(info["losses_reference"]) == 1 + 2
    assert len(info["positives_a_box_by_head"]) == 2 and info["positives_a_box"] >= 1.0


@pytest.mark.parametrize("fault", ["mse_box", "best_only", "v3_targets", "mish_as_silu",
                                   "half_batch", "unchanged"])
def test_a_planted_fault_is_not_correct(capsys, fault):
    rc, line, _ = _run(capsys, fault)
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_program_with_yolov3s_loss_is_refused_before_set_up(monkeypatch):
    """The parent's graph has no ``iou_loss``: the run exits with one line."""
    from amyloid_yolo_tpu_torch import graphspec
    real = graphspec.from_cfg

    def without(path):
        g = real(path)
        return dataclasses.replace(g, layers=tuple(
            dataclasses.replace(l, iou_loss="mse") if isinstance(l, graphspec.YoloSpec) else l
            for l in g.layers))

    monkeypatch.setattr(graphspec, "from_cfg", without)
    cell, cfg = train_cell()
    with pytest.raises(SystemExit, match=r"^error: the program's YoloSpec reads iou_loss "
                                         r"\['mse', 'mse'\] on mini_v4_train.cfg"):
        run.report(mini.Opts(), torch.device("cpu"), cell_dict=cell, config=cfg)


def test_targets_device_ms_reads_the_targets_ranges():
    read = spec.reader("targets_device_ms.train")
    ctx = {"kind": "train", "steps_traced": 8,
           "trace": {"ranges": {"train/loss": [0.004] * 8, "train/targets": [0.0001] * 24}}}
    assert read(ctx) == pytest.approx(0.3)
    ctx["trace"]["ranges"].pop("train/targets")
    assert read(ctx) is None
    assert read({"kind": "detect"}) is None
