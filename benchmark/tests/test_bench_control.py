"""The controls on the card: each cell with the lower precision in the
program's place (the port's ``int8_full`` Detector; the reference's step
with TF32 on) at the cell's own sizes, judged not correct under the
cell's limits.  Run on a machine with a card:
``python -m pytest benchmark/tests/test_bench_control.py -q``."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import cell, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2_147_483_001, 2_147_483_777])
def test_control_is_not_correct(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("the controls are read on the card: their lower precision is the card's")
    opts = SimpleNamespace(workload=workload, seed=seed, seconds=2.0, trace=0)
    out = cell.run_cell(opts, torch.device("cuda", 0), time.perf_counter(),
                        variant="control")
    assert out["correct"] is False, out["numbers"]
