"""Whole runs at the CPU tests' size, past the look for a card: the shape
of the last line, a sound program judged correct under the cells' limits,
and each fault the cells can have, planted under the timed path, judged
not correct."""

import json

import pytest
import torch

from benchmark import run
from benchmark.harness import spec
from benchmark.tests import mini


def _run(capsys, kind, variant=None, trace=0):
    make = {"detect": mini.detect_cell, "train": mini.train_cell}[kind]
    real = {"detect": "detect-416-b64", "train": "train-512a-b8"}[kind]
    cell, cfg = make(limits=spec.workload(real)["limits"])
    rc = run.report(mini.Opts(seed=2_147_483_647 + 12345, seconds=0.3, trace=trace),
                    torch.device("cpu"), cell_dict=cell, config=cfg, variant=variant)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("kind", ["detect", "train"])
def test_last_line_of_a_sound_run(capsys, kind):
    rc, line, err = _run(capsys, kind)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["metrics"]["setup_s"]["unit"] == "s"
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # the numbers compared, beside their limits, are the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checks"]) - 1:]
    assert all(t.startswith("check ") for t in tail)
    for name, c in line["checks"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"]


@pytest.mark.parametrize("kind,fault", [("detect", "half_batch"), ("detect", "stale_answer"),
                                        ("detect", "altered_answer"), ("detect", "scaled_boxes"),
                                        ("detect", "rescaled"), ("train", "half_batch"),
                                        ("train", "unchanged")])
def test_a_planted_fault_is_not_correct(capsys, kind, fault):
    rc, line, _ = _run(capsys, kind, fault)
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
