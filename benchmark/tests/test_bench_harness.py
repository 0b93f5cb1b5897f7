"""The harness finds every cell, configuration, traffic, limit and metric
reader by name, and ``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    w = spec.workload(cell)
    assert set(w) >= {"name", "config", "traffic", "chips", "why", "mix", "limits"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert w["mix"]["kind"] in ("detect", "train")
    assert os.path.exists(os.path.join(spec.BENCH_DIR, "harness", f"kind_{w['mix']['kind']}.py"))
    cfg = spec.config(w["config"])
    assert os.path.exists(cfg["cfg_path"])
    # every number the kind compares has a limit
    want = {"detect": {"conf_gap", "miss_margin", "box_gap"},
            "train": {"loss_gap", "grad_gap", "change_gap", "stats_gap"}}[w["mix"]["kind"]]
    assert set(w["limits"]) == want


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_found_by_name(config):
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    assert entry["file"].startswith("benchmark/") and entry["reduced"] == []
    cfg = spec.config(config)
    assert cfg["name"] == config and cfg["reduced"] == [] and cfg["source"] == entry["source"]
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = spec.reader(metric)
    assert callable(read)
    # a reader that finds nothing to read returns nothing
    assert read({"kind": "none"}) is None


def test_names_units_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:   # the cell reports what the metric moves
            assert any(e["name"] == m["moves"] for e in spec.metrics_of(cell, "end_to_end"))
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [e["name"] for e in spec.metrics_of(cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(cell, "per_layer")


def test_file_size():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb") as fh:
        assert len(fh.read()) <= 64 * 1024
    assert json.loads(json.dumps(BENCH)) == BENCH
