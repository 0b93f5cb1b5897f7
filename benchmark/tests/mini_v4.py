"""A small YOLOv4 configuration and traffic for the CPU tests of the
``detect_v4`` kind: Mish convs, a CSP split with one unit, SPP 5/9/13, a
PANet upsample and stride-2 route, and two grid-sensitive heads
(``scale_x_y`` 1.2 and 1.05), at 64²."""

import os

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "mini_v4.cfg")


def detect_cell(limits=None) -> tuple:
    cfg = {"name": "mini-v4-64", "cfg": "mini_v4.cfg", "cfg_path": CFG, "reduced": [],
           "calibration_tiles": 2, "objectness_share": 0.005, "head_std": 0.5,
           "reference_block": 2,
           "detector": {"conf_thres": 0.8, "nms_thres": 0.4, "capacity": 32,
                        "precision": "bf16", "lazy_decode": True, "model_size": 64,
                        "tile_size": 96}}
    cell = {"name": "detect-v4-mini", "config": "mini-v4-64", "traffic": "mini-tiles-v4",
            "chips": 1,
            "mix": {"kind": "detect_v4", "tile": 96, "batch": 4, "pool_batches": 3,
                    "in_flight": 2, "warmup_calls": 3, "traced_calls": 2,
                    "unrecorded_per_call": 2},
            "limits": limits or {}}
    return cell, cfg
