"""Everything the harness runs, found by name.

* ``BENCHMARK.json`` at the root of the checkout: the cells
  (``workloads``), their configurations and the metrics.
* ``benchmark/workloads/<cell>.json``: the cell's traffic, read by the
  general generator of its ``kind`` (:mod:`.traffic`).
* ``benchmark/configs/<config>.json``: the configuration (its source, the
  frozen ``.cfg`` beside it, the program's options).
* ``benchmark/limits/<cell>.json``: the limit of each number that the
  cell's comparison reads.
* ``benchmark/metrics/<metric>.py``: one reader a per-layer metric.

A new cell, configuration or metric is a new file and a new entry; no
file that is there changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, root: str = ROOT) -> dict:
    """The cell's entry in ``BENCHMARK.json`` merged with its traffic file
    and its limits: ``{"name", "config", "traffic", "chips", ..., "mix",
    "limits"}``."""
    cells = {w["name"]: w for w in benchmark(root)["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = dict(cells[name])
    bench = os.path.join(root, "benchmark")
    cell["mix"] = _load(os.path.join(bench, "workloads", f"{cell['traffic']}.json"))
    limits = os.path.join(bench, "limits", f"{name}.json")
    cell["limits"] = _load(limits) if os.path.exists(limits) else {}
    return cell


def config(name: str, root: str = ROOT) -> dict:
    """The configuration's file, with ``cfg_path`` made absolute."""
    entry = {c["name"]: c for c in benchmark(root)["configs"]}[name]
    path = os.path.join(root, entry["file"])
    cfg = _load(path)
    cfg["cfg_path"] = os.path.join(os.path.dirname(path), cfg["cfg"])
    return cfg


def metrics_of(cell_name: str, section: str, root: str = ROOT) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell_name`` reports: those without ``workloads``, and those that
    list it."""
    return [m for m in benchmark(root)[section]
            if "workloads" not in m or cell_name in m["workloads"]]


@functools.lru_cache(maxsize=None)
def reader(metric: str, root: str = ROOT) -> Callable[[dict], Optional[float]]:
    """``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric:{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer_values(cell_name: str, ctx: dict, root: str = ROOT) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds, with its
    unit; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in metrics_of(cell_name, "per_layer", root):
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
