"""A small configuration and traffic for the CPU tests: the harness's own
code paths at a size a test run holds (two residual units, two heads)."""

import os
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "mini.cfg")


def detect_cell(limits=None) -> tuple:
    cfg = {"name": "mini-64", "cfg": "mini.cfg", "cfg_path": CFG, "reduced": [],
           "calibration_tiles": 2, "objectness_share": 0.005, "head_std": 0.5, "reference_block": 2,
           "detector": {"conf_thres": 0.8, "nms_thres": 0.4, "capacity": 32,
                        "precision": "bf16", "lazy_decode": True, "model_size": 64,
                        "tile_size": 96},
           "control": {"precision": "int8_full"}}
    cell = {"name": "detect-mini", "config": "mini-64", "traffic": "mini-tiles", "chips": 1,
            "mix": {"kind": "detect", "tile": 96, "batch": 4, "pool_batches": 3,
                    "in_flight": 2, "warmup_calls": 3, "traced_calls": 2, "unrecorded_per_call": 2},
            "limits": limits or {}}
    return cell, cfg


def train_cell(limits=None) -> tuple:
    cfg = {"name": "mini-64-train", "cfg": "mini.cfg", "cfg_path": CFG, "reduced": [],
           "img_size": 64,
           "step": {"dtype": "float32", "accum": 2, "learning_rate": 1e-3, "augment": True},
           "control": {"allow_tf32": True}}
    cell = {"name": "train-mini", "config": "mini-64-train", "traffic": "mini-multiscale",
            "chips": 1,
            "mix": {"kind": "train", "tile": 96, "batch": 4, "pool_batches": 4,
                    "boxes": [1, 3], "box_size": [0.1, 0.4], "max_objects": 5,
                    "order": [64, 96],
                    "per_size": 2, "warm_per_size": 2, "traced_steps": 2,
                    "traced_size": 64, "unrecorded_per_call": 1},
            "limits": limits or {}}
    return cell, cfg


def Opts(seed=5, seconds=0.5, trace=0, workload="mini"):
    """The run's command-line options."""
    return SimpleNamespace(seed=seed, seconds=seconds, trace=trace, workload=workload)
