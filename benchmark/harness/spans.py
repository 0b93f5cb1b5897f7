"""The program's own spans in a finished trace, and what ran under each.

The port opens its ``detect/*`` and ``train/*`` spans
(``amyloid_yolo_tpu_torch/utils/spans.py``) as ``record_function`` ranges
on the thread that calls it.  :func:`readings` gives, for every span whose
name starts with one of ``prefixes``, one entry an occurrence, in host
order:

* ``host_s``: the span's host duration;
* ``device_s``: the device's busy time (the union of their intervals, as
  ``trace.busy_and_span`` takes it) of the kernels, copies and fills
  launched in the span; ``launches``: their number; ``h2d``: the
  host→device copies among them;
* ``idle_s``: the device's idle time inside the span's host interval while
  it was the innermost span of its thread.

Each device record is matched to the host call that launched it
(``trace.LAUNCH_CALLS``) by their shared correlation id, and belongs to the
innermost span open at that call's start on the call's thread, or, where
that thread has none open, to the innermost span of any thread open then.
So the backward's kernels, which autograd's device thread launches while
the calling thread waits in ``train/backward``, fall under
``train/backward``; and kernels launched through ``ctypes``, under no
PyTorch operator (K1, K2), fall under the span around them.  Records
launched under no span (the harness's drain) belong to none.  Host events
and device records are read on the one clock the profiler gives them.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

from .trace import LAUNCH_CALLS, busy_and_span

H2D = "Memcpy HtoD"


def readings(prof, prefixes: Sequence[str]) -> Dict[str, List[dict]]:
    """``{span name: [entry of each occurrence, in host order]}`` (seconds)."""
    from torch.autograd import DeviceType
    prefixes = tuple(prefixes)
    records, spans, calls = [], [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                records.append(e)
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith(prefixes):
                spans.append(e)
            elif e.name.startswith(LAUNCH_CALLS):
                calls[e.id] = e
    spans.sort(key=lambda s: s.time_range.start)
    under = {id(s): [] for s in spans}
    for r in records:
        call = calls.get(r.id)
        owner = _owner(call, spans) if call is not None else None
        if owner is not None:
            under[id(owner)].append(r)
    device = sorted((r.time_range.start, r.time_range.end) for r in records)
    gaps = _idle(device)
    starts = [a for a, _ in gaps]
    out: Dict[str, List[dict]] = {}
    for s in spans:
        mine = under[id(s)]
        out.setdefault(s.name, []).append({
            "host_s": (s.time_range.end - s.time_range.start) / 1e6,
            "device_s": busy_and_span((r.time_range.start, r.time_range.end)
                                      for r in mine)[0] / 1e6,
            "launches": len(mine),
            "h2d": sum(r.name.startswith(H2D) for r in mine),
            "idle_s": sum(_overlap(p, gaps, starts) for p in _own(s, spans)) / 1e6})
    return out


def _owner(call, spans):
    """The innermost span open at ``call``'s start on its thread, else on any."""
    t = call.time_range.start
    open_ = [s for s in spans if s.time_range.start <= t <= s.time_range.end]
    mine = [s for s in open_ if s.thread == call.thread]
    return min(mine or open_, key=lambda s: s.time_range.end - s.time_range.start, default=None)


def _idle(device) -> List[Tuple[float, float]]:
    """The stretches between the first device record's start and the last's
    end in which none ran, in order; ``device`` sorted ``(start, end)``."""
    gaps, end = [], None
    for a, b in device:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def _own(s, spans) -> List[Tuple[float, float]]:
    """``s``'s host interval less those of the spans nested in it on its
    thread; ``spans`` sorted by start."""
    a, b = s.time_range.start, s.time_range.end
    pieces, at = [], a
    for c in spans:
        if c is s or c.thread != s.thread or c.time_range.start < a or c.time_range.end > b:
            continue
        if c.time_range.start > at:
            pieces.append((at, c.time_range.start))
        at = max(at, c.time_range.end)
    if b > at:
        pieces.append((at, b))
    return pieces


def _overlap(piece, gaps, starts) -> float:
    """The length of ``piece`` that the sorted ``gaps`` cover."""
    a, b = piece
    total = 0.0
    for ga, gb in gaps[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if ga >= b:
            break
        total += max(0.0, min(b, gb) - max(a, ga))
    return total
