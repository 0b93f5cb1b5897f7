"""The port's bench (``bench_torch.py``) and the CLI's ``bench`` against the
reference's ``bench.py``: the same environment and defaults, the same
stdout lines for the same times, the same Detector options less the
approximate top-k, and no number without a card."""

import ast
import importlib.util
import json
import os

import jax
import numpy as np
import pytest

import amyloid_yolo_tpu.detectors as jax_detectors
from amyloid_yolo_tpu_torch.cli import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load("bench_torch.py", "bench_torch")


def _bench_py_env_defaults():
    """``{name: default}`` of every ``os.environ.get(name, default)`` in bench.py."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    found = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and ast.unparse(node.func.value) == "os.environ"):
            name, default = (a.value for a in node.args)
            found[name] = default
    return found


def test_environment_resolves_to_bench_py_defaults():
    assert bench_torch.DEFAULTS == _bench_py_env_defaults()
    assert bench_torch.config({}) == {
        "batch": 32, "iters": 30, "precision": "int8_full", "int8_ds": 32, "lazy": True,
        "approx": True, "s2d": True, "i32_hw": 0}
    got = bench_torch.config({"BENCH_BATCH": "8", "BENCH_LAZY": "0", "BENCH_S2D": "0",
                              "BENCH_PRECISION": "bf16", "BENCH_I32DEEP_HW": "26"})
    assert (got["batch"], got["lazy"], got["s2d"], got["precision"], got["i32_hw"]) == \
        (8, False, False, "bf16", 26)


class _FakeJaxDetector:
    """Stands in for the JAX Detector inside bench.py: records its options."""

    made = []

    def __init__(self, **kw):
        self.kw = kw
        self.params = None
        _FakeJaxDetector.made.append(kw)

    def _fn(self, params, inp):
        return np.zeros(1)

    def calibrate(self, tiles):
        pass

    def __call__(self, tiles):
        return np.zeros(1)


def _run_bench_py(monkeypatch, capsys, env, times):
    """bench.py's ``main`` with a stand-in Detector and ``measure`` returning
    ``times`` in call order (headline, bf16 parity, host-resized): its
    stdout lines and the Detector options it asked for."""
    bench = _load("bench.py", "bench_ref")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    queue = list(times)
    monkeypatch.setattr(bench, "measure", lambda *a, **k: queue.pop(0))
    monkeypatch.setattr(jax_detectors, "Detector", _FakeJaxDetector)
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if name == "jax_compilation_cache_dir" else update(name, value))
    _FakeJaxDetector.made = []
    bench.main()
    return capsys.readouterr().out.splitlines(), _FakeJaxDetector.made


@pytest.mark.parametrize("times", [(0.1071, 0.01474, 0.05), (0.0123456, 0.0456789, 0.02),
                                   (1.0 / 3.0, 2.0 / 7.0, 0.5)])
def test_json_lines_are_bench_py_lines(monkeypatch, capsys, times):
    batch = 2
    lines, _ = _run_bench_py(monkeypatch, capsys, {"BENCH_BATCH": str(batch),
                                                   "BENCH_ITERS": "1"}, times)
    t_head, t_bf16, _ = times
    want = [bench_torch.metric_line(batch, batch / t_bf16, "_bf16_parity"),
            bench_torch.metric_line(batch, batch / t_head)]
    assert lines == want
    assert [list(json.loads(l)) for l in lines] == [["metric", "value", "unit",
                                                     "vs_baseline"]] * 2


@pytest.mark.parametrize("env", [{}, {"BENCH_PRECISION": "int8_early", "BENCH_INT8_DS": "4"},
                                 {"BENCH_PRECISION": "bf16", "BENCH_LAZY": "0",
                                  "BENCH_APPROX": "0", "BENCH_S2D": "0"}],
                         ids=["default", "int8_early", "bf16"])
def test_detector_options_are_bench_py_options_less_approx_topk(monkeypatch, capsys, env):
    _, made = _run_bench_py(monkeypatch, capsys, dict(env, BENCH_BATCH="1", BENCH_ITERS="1"),
                            (0.1, 0.1, 0.1))
    head, parity, host_resized = made
    kw = bench_torch.detector_kwargs(bench_torch.config(env))
    assert {k: v for k, v in head.items() if k != "approx_topk"} == kw
    assert parity == {}
    assert {k: v for k, v in host_resized.items() if k != "approx_topk"} == \
        dict(kw, host_resize=True)


def test_main_raises_without_cuda():
    with pytest.raises(RuntimeError, match="measures the card"):
        bench_torch.main()


@pytest.mark.parametrize("argv", [["bench"], ["bench", "--device", "cpu"]])
def test_cli_bench_reaches_bench_torch(argv):
    with pytest.raises(RuntimeError, match="bench_torch.py measures the card"):
        cli.main(argv)


def test_batch_sweep_raises_without_cuda():
    sweep = _load("tools/batch_sweep_torch.py", "batch_sweep_torch")
    assert sweep.measure.__module__ == "bench_torch"  # the bench's own timing loop
    with pytest.raises(RuntimeError, match="measures the card"):
        sweep.main(["--batches", "8"])
