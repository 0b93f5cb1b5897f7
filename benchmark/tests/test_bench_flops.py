"""The frozen FLOP counter, walking the frozen ``.cfg``, against the
repository's ``tools/mfu_torch.py`` walking the port's graph."""

import os
import sys

import pytest

from benchmark.harness import flops, spec
from benchmark.reference import cfg as ref_cfg

sys.path.insert(0, os.path.join(spec.ROOT, "tools"))


@pytest.mark.parametrize("config,img", [("yolov3-amyloid-416", 416), ("yolov3-amyloid-512a", 512),
                                        ("yolov3-amyloid-512a", 608)])
def test_conv_flops_match_mfu_tool(config, img):
    import mfu_torch
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    path = spec.config(config)["cfg_path"]
    _, layers = ref_cfg.layers(path)
    assert flops.conv_flops(layers, img) == pytest.approx(
        mfu_torch.conv_gflops(from_cfg(path), img) * 1e9, rel=1e-12)


def test_residual_units_are_the_ports_fusible_units():
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    from amyloid_yolo_tpu_torch.models.darknet import fusible_residual_blocks
    path = spec.config("yolov3-amyloid-416")["cfg_path"]
    _, layers = ref_cfg.layers(path)
    assert ref_cfg.residual_units(layers) == sorted(fusible_residual_blocks(from_cfg(path)))
    assert len(ref_cfg.residual_units(layers)) == 23
    shapes = flops.residual_unit_shapes(layers, 416)
    assert shapes[0] == (208, 64) and shapes[-1] == (13, 1024)


def test_bounds_state_which_side_binds():
    _, layers = ref_cfg.layers(spec.config("yolov3-amyloid-416")["cfg_path"])
    f, b = flops.residual_unit_bound(layers, 416, 64)
    assert f / flops.PEAKS["bf16_flops"] > b / flops.PEAKS["hbm_bytes_per_s"]   # ops bind
    assert flops.preprocess_bytes(32, 416) == 32 * 9 * 416 * 416
