"""The port's shipped model configs and ``config/make_cfg.py`` against the
JAX package's, and ``ops/boxes.xyxy2xywh_np``.

The cfgs, ``classes.names`` and ``custom.data`` are byte-equal copies;
``graphspec.emit_cfg`` of the port's builder reproduces each cfg byte for
byte, and parsing each cfg gives the builder's spec (the ``416a`` and
``512a`` anchors are the committed ``bench_artifacts/anchors_*.json``
estimates).
"""

import json
import os

import numpy as np
import pytest

from amyloid_yolo_tpu.config import make_cfg as jax_make_cfg
from amyloid_yolo_tpu.ops import boxes as jax_boxes
from amyloid_yolo_tpu_torch import graphspec, parsecfg
from amyloid_yolo_tpu_torch.config import make_cfg
from amyloid_yolo_tpu_torch.ops import boxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIG = os.path.join(REPO, "amyloid_yolo_tpu_torch", "config")
JAX_CONFIG = os.path.join(REPO, "amyloid_yolo_tpu", "config")
CFGS = {"yolov3-amyloid.cfg": (416, None), "yolov3-amyloid-416a.cfg": (416, "anchors_416.json"),
        "yolov3-amyloid-512a.cfg": (512, "anchors_512.json")}


@pytest.mark.parametrize("shape,dtype", [((7, 4), np.float32), ((2, 3, 6), np.float64),
                                         ((4,), np.int64)])
def test_xyxy2xywh_np_matches_jax(shape, dtype):
    x = (np.random.RandomState(len(shape)).rand(*shape) * 500).astype(dtype)
    got = boxes.xyxy2xywh_np(x)
    want = jax_boxes.xyxy2xywh_np(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CFGS) + ["classes.names", "custom.data"])
def test_shipped_files_byte_equal(name):
    with open(os.path.join(PORT_CONFIG, name), "rb") as a, \
            open(os.path.join(JAX_CONFIG, name), "rb") as b:
        assert a.read() == b.read()


def _builder_spec(name):
    size, report = CFGS[name]
    anchors = None
    if report is not None:
        with open(os.path.join(REPO, "bench_artifacts", report)) as fh:
            anchors = [tuple(a) for a in json.load(fh)["anchors"]]
    return graphspec.yolov3_spec(num_classes=2, img_size=size, anchors=anchors)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cfg_is_the_builders_spec(name):
    path = os.path.join(PORT_CONFIG, name)
    spec = _builder_spec(name)
    assert graphspec.from_cfg(path) == spec
    with open(path) as fh:
        assert graphspec.emit_cfg(spec) == fh.read()
    blocks = parsecfg.parse_model_config(path)
    assert blocks[0]["type"] == "net" and int(blocks[0]["width"]) == CFGS[name][0]
    assert len(blocks) - 1 == len(spec.layers)


def test_make_cfg_writes_the_shipped_cfg(tmp_path, monkeypatch):
    monkeypatch.setattr(make_cfg, "__file__", str(tmp_path / "make_cfg.py"))
    path = make_cfg.main(2)
    assert path == str(tmp_path / "yolov3-amyloid.cfg")
    with open(path) as a, open(os.path.join(JAX_CONFIG, "yolov3-amyloid.cfg")) as b:
        assert a.read() == b.read()
    monkeypatch.setattr(jax_make_cfg, "__file__", str(tmp_path / "jax" / "make_cfg.py"))
    os.makedirs(tmp_path / "jax")
    with open(jax_make_cfg.main(3)) as a, open(make_cfg.main(3)) as b:
        assert a.read() == b.read()


def test_data_config_and_classes_of_the_shipped_copies():
    data = parsecfg.parse_data_config(os.path.join(PORT_CONFIG, "custom.data"))
    assert data["classes"] == "2" and data["names"].endswith("classes.names")
    assert parsecfg.load_classes(os.path.join(PORT_CONFIG, "classes.names")) == ["CAA", "Cored"]
