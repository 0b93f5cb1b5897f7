"""One run of one cell: the kind's set-up, window and comparison, then the
result line.

``run_cell`` is the whole run but the look for a card; ``variant`` puts a
control or a planted fault in the program's place (the readings tool and
the tests use it; the benchmark's own runs never do).
"""

from __future__ import annotations

import gc
import importlib
import sys
from typing import Optional

import torch

from . import compare, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "amyloid_yolo_tpu")


def steady_heap() -> None:
    """Collect once and freeze what set-up left on the heap: the collector's
    full passes in the window then walk only what the window made, not the
    imports and the set-up again and again.  :func:`run_cell` unfreezes."""
    gc.collect()
    gc.freeze()


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    relatives' or the JAX package's: ``amyloid_yolo_tpu_torch`` is not
    ``amyloid_yolo_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(opts, device: torch.device, t0: float, root: str = spec.ROOT,
             variant: Optional[str] = None, cell: Optional[dict] = None,
             config: Optional[dict] = None) -> dict:
    """The cell's result dict (see :func:`result_line`); ``cell`` and
    ``config`` replace what ``BENCHMARK.json`` names (the tests' small
    sizes)."""
    cell = cell or spec.workload(opts.workload, root)
    config = config or spec.config(cell["config"], root)
    kind = importlib.import_module(f"{__package__}.kind_{cell['mix']['kind']}")
    try:
        out = kind.run(opts, cell, config, device, t0, variant)
    finally:
        gc.unfreeze()
    out["cell"] = cell
    out["correct"] = (compare.verdict(out["numbers"], cell["limits"]) and out["failed"] == 0)
    return out


def result_line(out: dict, trace_on: bool, device: torch.device, root: str = spec.ROOT) -> dict:
    """The JSON object of the last line of standard output."""
    cell = out["cell"]
    if trace_on:
        metrics = spec.per_layer_values(cell["name"], out["ctx"], root)
    else:
        names = [m["name"] for m in spec.metrics_of(cell["name"], "end_to_end", root)]
        units = {m["name"]: m["unit"] for m in spec.benchmark(root)["end_to_end"]}
        metrics = {n: {"value": float(out["end_to_end"][n]), "unit": units[n]} for n in names}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device_entry(device, out["peak_bytes"])}
    if trace_on:
        red = out["trace"]
        line["device"]["busy_s"] = red["busy_s"]
        line["device"]["window_s"] = red["span_s"]
        line["breakdown"] = {"device_ops": trace.top_ops(red),
                             "idle_gaps": [[name[:120], s] for name, s in red["gaps"]]}
    line["checks"] = checks(out)
    return line


def checks(out: dict) -> dict:
    limits = out["cell"]["limits"]
    return {k: {"value": v, "limit": limits.get(k)} for k, v in out["numbers"].items()}


def check_lines(out: dict) -> str:
    rows = [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks(out).items()]
    return "\n".join(rows + [f"check failed: {out['failed']} of {out['attempted']} limit 0"])


def device_entry(device: torch.device, peak_bytes: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
