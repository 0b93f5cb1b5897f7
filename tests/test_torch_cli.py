"""The port's CLI (``python -m amyloid_yolo_tpu_torch.cli``) against the JAX
package's ``cli/main.py``:

* the parsers: for every command, the same options and defaults, except the
  port's ``--device`` (``PORT_ONLY``);
* the helpers ``_truthy``, ``_fast_path_kwargs`` (the port leaves out
  ``approx_topk``, ``FAST_PATH_DIFFERENCE``) and ``_capacity_kwargs``;
* ``export`` round trips both ways, equal to 1e-6;
* ``detect`` on three 1536² JPEG tiles with a mini cfg: the same
  ``+ Label:`` rows within 1e-3 and images of the same names (both sides in
  float32, ``_f32_detectors``);
* ``test`` wired to the port's ``evaluate``; ``train`` one batch on the CPU,
  its ``TrainConfig`` equal to the JAX CLI's field by field;
* every command that builds a model raises without CUDA unless
  ``--device cpu`` is given.
"""

import dataclasses
import functools
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import amyloid_yolo_tpu.detectors as jax_detectors_mod
import amyloid_yolo_tpu.training as jax_training_mod
import amyloid_yolo_tpu_torch.detectors as detectors_mod
import amyloid_yolo_tpu_torch.evaluate as evaluate_mod
import amyloid_yolo_tpu_torch.parallel.spatial as spatial_mod
import amyloid_yolo_tpu_torch.training as training_mod
from amyloid_yolo_tpu.cli import main as jax_cli
from amyloid_yolo_tpu.io import weights as jax_weights
from amyloid_yolo_tpu_torch.cli import main as cli
from amyloid_yolo_tpu_torch.graphspec import emit_cfg
from amyloid_yolo_tpu_torch.io import weights
from amyloid_yolo_tpu_torch.io.weights import params_from_jax

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec, stain_tile

#: parser differences: options only the port has (``fn`` is each side's
#: own command function)
PORT_ONLY = {"device"}
#: the kwargs of the JAX fast path the port leaves out: its Detector always
#: selects the candidate pool exactly (no approximate top-k on the GPU)
FAST_PATH_DIFFERENCE = {"approx_topk"}
LABEL = re.compile(r"\+ Label: (\w+), Conf: ([0-9.]+)")

ARGV = [
    ["train"],
    ["train", "--epochs", "3", "--multiscale_training", "False", "--s2d_stem", "True",
     "--distributed", "True", "-v", "--no_augment", "--ema_decay", "0.99"],
    ["test", "--weights_path", "w.pth"],
    ["detect"],
    ["detect", "--fast_path", "True", "--precision", "int8_full", "--batch_size", "auto",
     "--nms_pool", "128", "--calib_percentile", "99.9"],
    ["serve"],
    ["serve", "--port", "0", "--max_queue", "4", "--host_resize", "True"],
    ["sweep", "--directory", "d"],
    ["sweep", "--directory", "d", "--cross_tile_merge", "True", "--data_parallel", "2"],
    ["crop", "--wsi_dirs", "a", "b"],
    ["export", "--src", "a", "--dst", "b"],
    ["clear"],
    ["bench"],
]


def _vars(parser, argv, drop):
    return {k: v for k, v in vars(parser.parse_args(argv)).items() if k not in drop}


@pytest.mark.parametrize("argv", ARGV, ids=[" ".join(a) for a in ARGV])
def test_parser_matches_jax_but_for_device(argv):
    got = _vars(cli.build_parser(), argv, {"fn"} | PORT_ONLY)
    assert got == _vars(jax_cli.build_parser(), argv, {"fn"})
    assert cli.build_parser().parse_args(argv).device == "cuda"
    assert cli.build_parser().parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_every_command_and_option_is_mirrored():
    def options(parser):
        sub = next(a for a in parser._actions if a.choices and isinstance(a.choices, dict))
        return {name: sorted(o for a in sp._actions for o in a.option_strings)
                for name, sp in sub.choices.items()}

    port, ref = options(cli.build_parser()), options(jax_cli.build_parser())
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert sorted(set(port[name]) - {"--device"}) == ref[name], name
        assert "--device" in port[name]


@pytest.mark.parametrize("v", [True, False, "True", "true", "TRUE", "1", "False", "0", None,
                               "yes", 1, 0])
def test_truthy_matches_jax(v):
    assert cli._truthy(v) == jax_cli._truthy(v)


FAST_ARGV = [["detect"], ["detect", "--fast_path", "True"],
             ["detect", "--fast_path", "True", "--precision", "int8_full"],
             ["serve", "--fast_path", "true", "--calib_percentile", "99.9"],
             ["sweep", "--directory", "d", "--fast_path", "1", "--precision", "int8_early"],
             ["detect", "--nms_pool", "256"], ["serve", "--nms_pool", "0"]]


@pytest.mark.parametrize("argv", FAST_ARGV, ids=[" ".join(a) for a in FAST_ARGV])
def test_fast_path_and_capacity_kwargs_match_jax(argv):
    args = cli.build_parser().parse_args(argv)
    ref = jax_cli.build_parser().parse_args(argv)
    want = {k: v for k, v in jax_cli._fast_path_kwargs(ref).items()
            if k not in FAST_PATH_DIFFERENCE}
    assert cli._fast_path_kwargs(args) == want
    assert cli._capacity_kwargs(args) == jax_cli._capacity_kwargs(ref)
    if "int8_full" in argv:
        assert jax_cli._fast_path_kwargs(ref)["s2d_stem"] is True
    if cli._fast_path_kwargs(args):
        assert jax_cli._fast_path_kwargs(ref)["approx_topk"] is True


def test_fast_path_kwargs_warn_on_ignored_flags():
    args = cli.build_parser().parse_args(["detect", "--precision", "int8_full"])
    with pytest.warns(UserWarning, match="only take effect"):
        assert cli._fast_path_kwargs(args) == {}


# -- export -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A mini cfg the port emits, JAX weights, and the port's ``.pth``."""
    root = tmp_path_factory.mktemp("mini")
    cfg = root / "mini.cfg"
    cfg.write_text(emit_cfg(port_mini_spec()))
    params = jax_params_np(mini_spec(), 4, bn_noise=True, jit=True)
    pth = root / "port.pth"
    torch.save(params_from_jax(params, port_mini_spec()), pth)
    return {"root": root, "cfg": str(cfg), "params": params, "pth": str(pth)}


def _assert_jax_params_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        for n, a in v.items():
            np.testing.assert_allclose(np.asarray(got[k][n]), a, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k}.{n}")


def test_port_exports_what_jax_reads(mini, tmp_path, capsys):
    spec = jax_cli._spec_from_args(type("A", (), {"model_def": mini["cfg"]})())
    for dst in ("out.pth", "out.weights", "out_darknet.bin"):
        path = str(tmp_path / dst)
        assert cli.main(["export", "--model_def", mini["cfg"], "--src", mini["pth"],
                         "--dst", path, "--seen", "7"]) == 0
        if dst.endswith(".pth"):
            got = jax_weights.load_pretrained(spec, path)
        else:
            got, header = jax_weights.load_darknet_weights(spec, path)
            assert header[3] == 7
        _assert_jax_params_equal(got, mini["params"])
    assert "exported" in capsys.readouterr().out


def test_port_reads_what_jax_exports(mini, tmp_path):
    want = torch.load(mini["pth"])
    spec = port_mini_spec()
    for dst in ("jax.pth", "jax.weights"):
        path = str(tmp_path / dst)
        assert jax_cli.main(["export", "--model_def", mini["cfg"], "--src", mini["pth"],
                             "--dst", path]) == 0
        got = weights.load_pretrained(spec, path)
        for k, v in got.items():
            torch.testing.assert_close(v, want[k].to(v.dtype), rtol=1e-6, atol=1e-6)
        # and through the port's CLI, back to a .pth
        back = str(tmp_path / f"back_{dst}.pth")
        assert cli.main(["export", "--model_def", mini["cfg"], "--src", path,
                         "--dst", back]) == 0
        for k, v in weights.load_pretrained(spec, back).items():
            torch.testing.assert_close(v, want[k].to(v.dtype), rtol=1e-6, atol=1e-6)


def test_export_refuses_orbax(mini, tmp_path):
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        cli.main(["export", "--src", str(tmp_path / "ckpt") + "#ema", "--dst", "x.pth"])
    with pytest.raises(NotImplementedError, match="orbax"):
        cli.main(["export", "--model_def", mini["cfg"], "--src", mini["pth"],
                  "--dst", str(tmp_path / "orbax_dir")])


# -- detect, test, train ------------------------------------------------------

@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiles")
    rng = np.random.RandomState(8)
    for i in range(3):
        Image.fromarray(stain_tile(rng, 1536, 1536)).save(d / f"t{i}.jpg", quality=90)
    return str(d)


def _f32_detectors(monkeypatch):
    """Both CLIs' Detectors in float32 (their default is bf16, whose
    rounding differs between the packages by more than the rows' 1e-3)."""
    monkeypatch.setattr(jax_detectors_mod, "Detector",
                        functools.partial(jax_detectors_mod.Detector,
                                          compute_dtype=jnp.float32))
    monkeypatch.setattr(detectors_mod, "Detector",
                        functools.partial(detectors_mod.Detector,
                                          compute_dtype=torch.float32))


def test_detect_matches_jax_cli(mini, tiles, tmp_path, monkeypatch, capsys):
    _f32_detectors(monkeypatch)
    monkeypatch.chdir(tmp_path)
    common = ["detect", "--model_def", mini["cfg"], "--weights_path", mini["pth"],
              "--image_folder", tiles, "--img_size", "64", "--conf_thres", "0.3",
              "--batch_size", "2", "--write_CAA_detections_to_pickle", "True"]
    assert jax_cli.main(common + ["--output_dir", "out_jax"]) == 0
    want = LABEL.findall(capsys.readouterr().out)
    with open("pickles/CAA_detections.pkl", "rb") as fh:
        want_pkl = __import__("pickle").load(fh)
    assert cli.main(common + ["--output_dir", "out_port", "--device", "cpu"]) == 0
    got = LABEL.findall(capsys.readouterr().out)
    with open("pickles/CAA_detections.pkl", "rb") as fh:
        got_pkl = __import__("pickle").load(fh)
    assert len(got) == len(want) > 3
    for (gn, gc), (wn, wc) in zip(got, want):
        assert gn == wn and abs(float(gc) - float(wc)) <= 1e-3
    assert sorted(os.listdir("out_port")) == sorted(os.listdir("out_jax"))
    assert len(os.listdir("out_port")) == 3
    assert sorted(got_pkl) == sorted(want_pkl)
    assert [len(v) for _, v in sorted(got_pkl.items())] == \
        [len(v) for _, v in sorted(want_pkl.items())]


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(4):
        p = root / "images" / f"t{i}.jpg"
        Image.fromarray(stain_tile(rng, 128, 128)).save(p, quality=90)
        (root / "labels" / f"t{i}.txt").write_text(
            f"1 0.5 0.5 0.2 0.2\n0 {0.2 + 0.1 * i:.2f} 0.3 0.15 0.1\n1 0.5 0.5 1.0 1.0\n")
        paths.append(str(p))
    (root / "train.txt").write_text("\n".join(paths[:2]) + "\n")
    (root / "valid.txt").write_text("\n".join(paths[2:]) + "\n")
    (root / "classes.names").write_text("CAA\nCored\n")
    (root / "custom.data").write_text(
        f"classes=2\ntrain={root}/train.txt\nvalid={root}/valid.txt\n"
        f"names={root}/classes.names\n")
    return root


def test_test_command_runs_the_port_evaluate(mini, tiny_dataset, monkeypatch, capsys):
    calls = []
    real = evaluate_mod.evaluate

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(evaluate_mod, "evaluate", spy)
    rc = cli.main(["test", "--model_def", mini["cfg"], "--weights_path", mini["pth"],
                   "--data_config", str(tiny_dataset / "custom.data"), "--img_size", "64",
                   "--conf_thres", "0.3", "--batch_size", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(calls) == 1 and calls[0]["device"] == "cpu" and calls[0]["img_size"] == 64
    assert calls[0]["nms_capacity"] == 128 and calls[0]["conf_thres"] == 0.3
    assert (rc, "mAP:" in out) in ((0, True), (1, False))


def test_train_config_matches_jax_and_one_batch_trains(mini, tiny_dataset, tmp_path,
                                                      monkeypatch):
    argv = ["train", "--model_def", mini["cfg"], "--data_config",
            str(tiny_dataset / "custom.data"), "--epochs", "1", "--batch_size", "2",
            "--img_size", "64", "--multiscale_training", "False", "--max_batches_per_epoch",
            "1", "--checkpoint_dir", str(tmp_path / "ck"), "--logdir", str(tmp_path / "logs"),
            "--gradient_accumulations", "1", "--ema_decay", "0.9"]
    captured = {}

    class Capture:
        def __init__(self, cfg, spec=None, **kw):
            captured[type(cfg).__module__] = cfg

        def train(self):
            return None

    monkeypatch.setattr(jax_training_mod, "Trainer", Capture)
    assert jax_cli.main(argv) == 0
    with monkeypatch.context() as m:
        m.setattr(training_mod, "Trainer", Capture)
        assert cli.main(argv + ["--device", "cpu"]) == 0
    want = dataclasses.asdict(captured["amyloid_yolo_tpu.training"])
    assert dataclasses.asdict(captured["amyloid_yolo_tpu_torch.training"]) == want

    assert cli.main(argv + ["--device", "cpu"]) == 0
    ckpts = os.listdir(tmp_path / "ck")
    assert ckpts == ["yolov3_ckpt_0.pt"]
    ck = torch.load(tmp_path / "ck" / ckpts[0], weights_only=True)
    assert (ck["step"], ck["seen"]) == (1, 2)
    got = weights.load_pretrained(port_mini_spec(), str(tmp_path / "ck" / ckpts[0]) + "#ema")
    assert sorted(got) == sorted(weights.load_pretrained(port_mini_spec(), mini["pth"]))


@pytest.mark.parametrize("s2d,layout,want", [("True", "nhwc", True), ("False", "planar", False),
                                             ("auto", None, True)])
def test_train_layout_options_reach_the_trainer(mini, tiny_dataset, tmp_path, monkeypatch,
                                                s2d, layout, want):
    """``train --s2d_stem`` and ``--image_layout`` reach ``TrainConfig`` as
    the JAX CLI fills it, and the ``Trainer`` resolves the stem (auto: on,
    the mini cfg has the YOLOv3 stem with BN) and builds its step with it."""
    argv = ["train", "--model_def", mini["cfg"], "--data_config",
            str(tiny_dataset / "custom.data"), "--logdir", str(tmp_path / "logs"),
            "--s2d_stem", s2d] + (["--image_layout", layout] if layout else [])
    built, made = [], []

    class Built(training_mod.Trainer):
        def __init__(self, cfg, spec=None, device=None):
            super().__init__(cfg, spec=spec, device=device)
            built.append(self)

        def train(self):
            return None

    captured = {}

    class Capture:
        def __init__(self, cfg, spec=None, **kw):
            captured["jax"] = cfg

        def train(self):
            return None

    monkeypatch.setattr(jax_training_mod, "Trainer", Capture)
    assert jax_cli.main(argv) == 0
    make_step = training_mod.steps_mod.make_accum_train_step
    monkeypatch.setattr(training_mod.steps_mod, "make_accum_train_step",
                        lambda *a, **kw: made.append(kw) or make_step(*a, **kw))
    monkeypatch.setattr(training_mod, "Trainer", Built)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    (tr,) = built
    assert (tr.cfg.s2d_stem, tr.cfg.image_layout) == (captured["jax"].s2d_stem,
                                                      captured["jax"].image_layout)
    assert tr.cfg.image_layout == (layout or "planar")
    assert tr.s2d_stem is want
    assert (made[0]["s2d_stem"], made[0]["image_layout"]) == (want, layout or "planar")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_model_commands_need_cuda_or_an_explicit_cpu(mini, tiny_dataset, tiles, tmp_path):
    data = str(tiny_dataset / "custom.data")
    for argv in (["detect", "--model_def", mini["cfg"], "--image_folder", tiles,
                  "--output_dir", str(tmp_path / "o")],
                 ["serve", "--model_def", mini["cfg"], "--port", "0"],
                 ["sweep", "--model_def", mini["cfg"], "--directory", str(tmp_path)],
                 ["test", "--model_def", mini["cfg"], "--weights_path", mini["pth"],
                  "--data_config", data],
                 ["train", "--model_def", mini["cfg"], "--data_config", data]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_unported_commands_raise(mini, tiny_dataset, tmp_path, monkeypatch):
    """``bench`` still raises; ``train --spatial_shard`` (ported) trains one
    batch height-sharded over two CPU entries and refuses ``--distributed``."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        cli.main(["bench"])
    runs = []
    real = spatial_mod.SpatialShards.run

    def spy(self, *a, **kw):
        runs.append(self.mesh.shape)
        return real(self, *a, **kw)

    monkeypatch.setattr(spatial_mod.SpatialShards, "run", spy)
    argv = ["train", "--model_def", mini["cfg"], "--data_config",
            str(tiny_dataset / "custom.data"), "--epochs", "1", "--batch_size", "2",
            "--img_size", "64", "--multiscale_training", "False", "--max_batches_per_epoch",
            "1", "--checkpoint_dir", str(tmp_path / "ck"), "--logdir", str(tmp_path / "logs"),
            "--gradient_accumulations", "1", "--evaluation_interval", "0",
            "--spatial_shard", "2", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert runs == [{"dp": 1, "sp": 2}]
    ck = torch.load(tmp_path / "ck" / "yolov3_ckpt_0.pt", weights_only=True)
    assert (ck["step"], ck["seen"]) == (1, 2)
    assert all(torch.isfinite(v).all() for v in ck["params"].values() if v.is_floating_point())
    with pytest.raises(ValueError, match="spatial_shard does not compose with distributed"):
        cli.main(argv + ["--distributed", "True", "--coordinator_address", "127.0.0.1:1",
                         "--num_processes", "1", "--process_id", "0"])
    assert not torch.distributed.is_initialized()


def test_clear(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    (out / "x.png").write_bytes(b"x")
    assert cli.main(["clear", "--output_dir", str(out)]) == 0
    assert os.listdir(out) == []
