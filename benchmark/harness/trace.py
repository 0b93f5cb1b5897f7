"""Checked traces and their reduction to per-layer readings.

Copied from the repository's ``tools/trace_summary_torch.py``
(``busy_and_span``, ``warmed_profile``, ``record_counts``,
``trace_complete``, ``checked_trace``): tracing starts late on the card,
so a trace drops a warm-up step; and a trace can lose device records, so
it is taken again until it kept one for each launch call of the host but
``unrecorded`` (one cuDNN memset of each bf16 call never leaves one).

:func:`reduce` turns the finished profiler into what the metric readers
read: every device operation, the busy time and the span, the device time
of the kernels launched under each named host range (a range's own thread
only: autograd's backward kernels are launched from another thread and
fall outside every range), and the longest idle gaps with what the host
was doing then.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List, Sequence, Tuple

# the host's calls that start device work, as a trace's CPU side records them
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")
TRACE_TRIES = 8


def busy_and_span(intervals) -> Tuple[float, float]:
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


def warmed_profile():
    """A CPU and CUDA ``torch.profiler.profile`` whose first step is a
    warm-up: the caller runs the warm-up work, synchronises, calls
    ``prof.step()`` once, and only what follows is kept."""
    from torch.profiler import ProfilerActivity, profile, schedule
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1))


def record_counts(events) -> Tuple[int, int]:
    """``(device records, launch calls)`` among a profiler's events."""
    from torch.autograd import DeviceType
    records = calls = 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            records += not e.is_user_annotation
        elif e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH_CALLS):
            calls += 1
    return records, calls


def trace_complete(records: int, calls: int, unrecorded: int = 0) -> bool:
    return records >= calls - unrecorded


def checked_trace(take: Callable, unrecorded: int = 0, tries: int = TRACE_TRIES):
    """``take()`` until its trace is complete, at most ``tries`` times;
    returns the profiler and ``[records, calls]`` of every try."""
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
    from torch.autograd import DeviceType
    kinds = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            kinds["record: " + (e.name[:40] if e.name.startswith("Mem") else "kernel")] += 1
        elif e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH_CALLS):
            kinds["call: " + e.name] += 1
    return dict(kinds)


def _under(e):
    yield from e.kernels
    for c in e.cpu_children:
        yield from _under(c)


def reduce(prof, range_prefixes: Sequence[str] = ()) -> dict:
    """The readings of a finished trace (times in seconds)."""
    from torch.autograd import DeviceType
    events = prof.events()
    device, cpu = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            device.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
        elif e.device_type == DeviceType.CPU and not e.name.startswith("ProfilerStep"):
            cpu.append(e)
    busy, span = busy_and_span((a, b) for _, a, b in device)
    ranges: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    for e in cpu:
        if range_prefixes and e.name.startswith(tuple(range_prefixes)):
            ranges[e.name].append((e.time_range.start,
                                   sum(k.duration for k in _under(e)) / 1e6))
    by_name = collections.Counter()
    for name, a, b in device:
        by_name[name] += b - a
    # each range's device seconds, one entry an occurrence, in host order
    ordered = {k: [s for _, s in sorted(v)] for k, v in ranges.items()}
    return {"device": device, "busy_s": busy, "span_s": span, "ranges": ordered,
            "by_name": dict(by_name), "gaps": _gaps(device, cpu), "kinds": record_kinds(events)}


def _gaps(device, cpu, top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest idle stretches between device operations, each
    named by the innermost host operation running at its middle (with the
    outermost named range around it)."""
    spans = sorted((a, b) for _, a, b in device)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2 * 1e6
        around = [e for e in cpu if e.time_range.start <= mid <= e.time_range.end]
        inner = min(around, key=lambda e: e.time_range.elapsed_us(), default=None)
        named = [e for e in around if e.is_user_annotation or "/" in e.name]
        outer = max(named, key=lambda e: e.time_range.elapsed_us(), default=None)
        label = "host idle" if inner is None else inner.name
        if outer is not None and outer is not inner:
            label = f"{outer.name} > {label}"
        out.append((label, b - a))
    return out


def top_ops(trace: dict, n: int = 10) -> List[List]:
    rows = sorted(trace["by_name"].items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], s] for name, s in rows]
