"""Port graph spec and config parsers against the JAX package's."""

import dataclasses
import os

import pytest

from amyloid_yolo_tpu import graphspec as jax_gs
from amyloid_yolo_tpu import parsecfg as jax_cfg
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch import graphspec as port_gs
from amyloid_yolo_tpu_torch import parsecfg as port_cfg
from amyloid_yolo_tpu_torch.models import darknet as port_darknet

from minispec import mini_spec
from torch_port_helpers import port_mini_spec

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "amyloid_yolo_tpu", "config")


def _layer_fields(layer) -> dict:
    """A layer's fields; the port's ``YoloSpec.scale_x_y`` (YOLOv4's, which
    the JAX package lacks) left out where it is 1, YOLOv3's decode."""
    d = dataclasses.asdict(layer)
    if isinstance(layer, port_gs.YoloSpec) and d["scale_x_y"] == 1.0:
        del d["scale_x_y"]
    return d


def _as_plain(spec):
    return (dataclasses.asdict(spec.net),
            [(type(l).__name__, _layer_fields(l)) for l in spec.layers],
            spec.out_channels, spec.consumers)


def assert_same_spec(port, ref):
    p, r = _as_plain(port), _as_plain(ref)
    assert p[0] == r[0]
    assert len(p[1]) == len(r[1])
    for i, (a, b) in enumerate(zip(p[1], r[1])):
        assert a == b, f"layer {i}"
    assert p[2] == r[2]
    assert p[3] == r[3]


@pytest.mark.parametrize("num_classes,img_size", [(2, 416), (80, 608)])
def test_yolov3_spec_matches(num_classes, img_size):
    port = port_gs.yolov3_spec(num_classes=num_classes, img_size=img_size)
    assert_same_spec(port, jax_gs.yolov3_spec(num_classes=num_classes, img_size=img_size))
    assert port_gs.emit_cfg(port) == jax_gs.emit_cfg(
        jax_gs.yolov3_spec(num_classes=num_classes, img_size=img_size))


def test_mini_spec_matches_through_builder_and_cfg(tmp_path):
    ref = mini_spec(num_classes=2, img_size=64)
    assert_same_spec(port_mini_spec(num_classes=2, img_size=64), ref)
    path = tmp_path / "mini.cfg"
    path.write_text(jax_gs.emit_cfg(ref))
    assert_same_spec(port_gs.from_cfg(str(path)), jax_gs.from_cfg(str(path)))


@pytest.mark.parametrize("cfg", ["yolov3-amyloid.cfg", "yolov3-amyloid-416a.cfg",
                                 "yolov3-amyloid-512a.cfg"])
def test_from_cfg_matches_on_shipped_configs(cfg):
    path = os.path.join(CONFIG, cfg)
    assert_same_spec(port_gs.from_cfg(path), jax_gs.from_cfg(path))


def test_data_config_and_classes_match():
    data = os.path.join(CONFIG, "custom.data")
    names = os.path.join(CONFIG, "classes.names")
    assert port_cfg.parse_data_config(data) == jax_cfg.parse_data_config(data)
    assert port_cfg.load_classes(names) == jax_cfg.load_classes(names)


@pytest.mark.parametrize("which,count", [("yolov3", 23), ("mini", 4)])
def test_fusible_residual_blocks(which, count):
    if which == "yolov3":
        port, ref = port_gs.yolov3_spec(), jax_gs.yolov3_spec()
    else:
        port, ref = port_mini_spec(), mini_spec()
    blocks = port_darknet.fusible_residual_blocks(port)
    assert len(blocks) == count
    assert blocks == jax_darknet.fusible_residual_blocks(ref)
