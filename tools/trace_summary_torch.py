"""Summarize a ``torch.profiler`` trace: top device operations by total
time, and the device's busy and idle share over the traced window.

Reads the Chrome trace that ``prof.export_chrome_trace(path)`` writes (or
``torch.profiler.tensorboard_trace_handler`` writes into a directory), a
``.json`` or ``.json.gz`` file or the newest such file under a directory.
The device's operations are the events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; its busy time is the union of their
intervals (operations on several streams may overlap) and its window runs
from the first one's start to the last one's end.

Taking a trace: :func:`warmed_profile` drops a warm-up step (tracing
starts late on the card), and :func:`checked_trace` takes a trace again
until it kept a device record for each of the host's launch calls
(:data:`LAUNCH_CALLS`), at most :data:`TRACE_TRIES` times.

Usage:
    python tools/trace_summary_torch.py <trace.json[.gz] or directory> [N]

Capture example:
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det(tiles); torch.cuda.synchronize()
    prof.export_chrome_trace("logs/traces/infer.json")
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import math
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_json(root: str) -> str:
    if os.path.isfile(root):
        return root
    hits = [p for pattern in ("*.json", "*.json.gz")
            for p in glob.glob(os.path.join(root, "**", pattern), recursive=True)]
    if not hits:
        raise FileNotFoundError(f"no .json or .json.gz trace under {root}")
    return max(hits, key=os.path.getmtime)  # newest capture


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)


def device_events(trace: dict) -> list:
    """``(name, start_us, end_us)`` of every device operation in the trace."""
    return [(e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]


def busy_and_span(intervals) -> tuple:
    """``(busy, span)`` of ``(start, end)`` intervals: the length of their
    union, and the distance from the first start to the last end."""
    spans = sorted(intervals)
    if not spans:
        return 0.0, 0.0
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, max(b for _, b in spans) - spans[0][0]


def warmed_profile(activities):
    """A ``torch.profiler.profile`` whose first step is a warm-up: the
    caller runs the warm-up work, synchronises and calls ``prof.step()``
    once, and only what follows is kept.  Tracing starts late on the card,
    and a trace started cold may miss its first kernels."""
    from torch.profiler import profile, schedule
    return profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1))


# the host's calls that start device work, as a trace's CPU side records them
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")
# Even warmed, a trace can lose device records: of sixteen warmed 2- and
# 4-step traces of the B=8 train step on an H100, three 2-step ones kept
# 6.5-156 fewer kernels a step than the host made launch calls, while those
# calls were the same in every trace.
TRACE_TRIES = 8


def record_counts(events) -> tuple:
    """``(device records, launch calls)`` among a profiler's events: the
    kernels, copies and fills on the device (the user ranges the profiler
    also draws there left out), and the host's calls of ``LAUNCH_CALLS``."""
    from torch.autograd import DeviceType
    records = calls = 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            records += not e.is_user_annotation
        elif e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH_CALLS):
            calls += 1
    return records, calls


def trace_complete(records: int, calls: int, unrecorded: int = 0) -> bool:
    """The trace kept a device record for every launch call of the host but
    ``unrecorded``."""
    return records >= calls - unrecorded


def checked_trace(take, unrecorded: int = 0, tries: int = TRACE_TRIES):
    """Call ``take()``, which takes one trace and returns the finished
    profiler, until the trace is complete (:func:`trace_complete`), at most
    ``tries`` times.  Returns that profiler and ``[records, calls]`` of
    every try; raises ``AssertionError`` when no try was complete."""
    counts = []
    for _ in range(tries):
        prof = take()
        counts.append(list(record_counts(prof.events())))
        if trace_complete(*counts[-1], unrecorded):
            return prof, counts
    raise AssertionError(f"no trace of {tries} kept a device record for every launch call "
                         f"but {unrecorded}: [records, calls] {counts}; the last by kind "
                         f"{record_kinds(prof.events())}")


def record_kinds(events) -> dict:
    """The device records by kind (kernel, or the copy's or fill's name) and
    the host's launch calls by name: where a trace lost records."""
    import collections
    from torch.autograd import DeviceType
    kinds = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            kinds["record: " + (e.name[:40] if e.name.startswith("Mem") else "kernel")] += 1
        elif e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH_CALLS):
            kinds["call: " + e.name] += 1
    return dict(kinds)


def summarize(path: str, top: int = 20, out=sys.stdout) -> dict:
    """Print the top ``top`` device operations by total time and the busy
    and idle shares; return them."""
    events = device_events(load_trace(path))
    total = collections.Counter()
    count = collections.Counter()
    for name, a, b in events:
        total[name] += b - a
        count[name] += 1
    busy, span = busy_and_span((a, b) for _, a, b in events)
    rows = [(name, us / 1e3, count[name]) for name, us in total.most_common(top)]
    print(f"{'total ms':>10}  {'calls':>5}  op", file=out)
    for name, ms, n in rows:
        print(f"{ms:10.3f}  {n:5d}  {name[:100]}", file=out)
    share = busy / span if span else float("nan")
    print(f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms window in "
          f"{len(events)} operations: busy share {share:.4f}, idle share "
          f"{1 - share:.4f}", file=out)
    return {"rows": rows, "launches": len(events), "busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "busy_share": share, "idle_share": 1 - share}


if __name__ == "__main__":
    root = sys.argv[1] if len(sys.argv) > 1 else "logs/traces"
    top = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    summarize(find_trace_json(root), top)
