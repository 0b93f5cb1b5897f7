"""``harness/spans.readings`` on a profiler's events built by hand: which
span each device record belongs to, across threads, and the idle time
inside each span."""

import itertools
from types import SimpleNamespace as Ev

import pytest
from torch.autograd import DeviceType

from benchmark.harness import spans

MAIN, AUTOGRAD = 1, 2


def _t(a, b):
    return Ev(start=a, end=b)


def _span(name, a, b, thread=MAIN):
    return [Ev(device_type=DeviceType.CPU, is_user_annotation=True, name=name, thread=thread,
               time_range=_t(a, b), id=0)]


_ids = itertools.count(1)


def _launch(at, *runs, thread=MAIN, call="cudaLaunchKernel"):
    """A launch call at ``at`` µs on ``thread`` and the device records it
    started, each ``(start, end)`` or ``(start, end, name)``; the call's
    operator ``aten::mul`` holds no record, as a ``ctypes`` launch has none."""
    out = [Ev(device_type=DeviceType.CPU, is_user_annotation=False, name="aten::mul",
              thread=thread, time_range=_t(at, at + 1), id=0)]
    for run in runs:
        i = next(_ids)
        out.append(Ev(device_type=DeviceType.CPU, is_user_annotation=False, name=call,
                      thread=thread, time_range=_t(at, at + 0.5), id=i))
        out.append(Ev(device_type=DeviceType.CUDA, is_user_annotation=False,
                      name=run[2] if len(run) > 2 else "k", time_range=_t(*run[:2]), id=i))
    return out


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _read(*groups, prefixes=("train/",)):
    return spans.readings(_Prof([e for g in groups for e in g]), prefixes)


def test_a_launch_on_another_thread_goes_to_the_span_that_holds_it():
    """autograd's thread opens no span: its launches at 25 µs belong to the
    main thread's ``train/backward`` (20–60), not to ``train/forward``."""
    got = _read(_span("train/forward", 0, 20), _launch(5, (6, 10)),
                _span("train/backward", 20, 60),
                _launch(25, (26, 32), (32, 34), thread=AUTOGRAD),
                _launch(70, (71, 80), thread=AUTOGRAD))   # under no span
    back, fwd = got["train/backward"][0], got["train/forward"][0]
    assert back["device_s"] == pytest.approx(8e-6) and back["launches"] == 2
    assert fwd["device_s"] == pytest.approx(4e-6) and fwd["launches"] == 1
    assert back["host_s"] == pytest.approx(40e-6)


def test_the_innermost_span_of_the_launching_thread_wins():
    """A launch inside ``train/inner`` on the main thread goes there, not to
    the enclosing ``train/outer``, nor to a shorter span open on another
    thread at the same time."""
    got = _read(_span("train/outer", 0, 100), _span("train/inner", 40, 60),
                _span("train/other", 44, 46, thread=AUTOGRAD),
                _launch(45, (50, 53)), _launch(10, (12, 17)))
    assert got["train/inner"][0]["device_s"] == pytest.approx(3e-6)
    assert got["train/outer"][0]["device_s"] == pytest.approx(5e-6)
    assert got["train/other"][0]["launches"] == 0


def test_device_time_is_busy_time_and_idle_counts_where_the_span_is_innermost():
    """Records 0–10, 20–50 and 30–40 (overlapping) launched under
    ``train/outer``: its busy time is 40 µs, not 50.  70–100 launched under
    ``train/inner``.  Idle 10–20 and 50–70: the outer span owns 0–40 and
    60–100 (10 + 10 idle), the inner one 40–60 (10 idle)."""
    got = _read(_span("train/outer", 0, 100), _span("train/inner", 40, 60),
                _launch(1, (0, 10), (20, 50), (30, 40)), _launch(45, (70, 100)))
    outer, inner = got["train/outer"][0], got["train/inner"][0]
    assert outer["device_s"] == pytest.approx(40e-6) and outer["launches"] == 3
    assert inner["device_s"] == pytest.approx(30e-6)
    assert outer["idle_s"] == pytest.approx(20e-6)
    assert inner["idle_s"] == pytest.approx(10e-6)


def test_h2d_counts_host_to_device_copies():
    got = _read(_span("train/loss", 0, 50),
                _launch(5, (5, 6, "Memcpy HtoD (Pageable -> Device)"), (6, 7),
                        (7, 8, "Memcpy DtoH (Device -> Pageable)"), call="cudaMemcpyAsync"),
                _launch(20, (20, 21, "Memcpy HtoD (Pinned -> Device)"), call="cudaMemcpyAsync"))
    assert got["train/loss"][0]["h2d"] == 2
    assert got["train/loss"][0]["launches"] == 4


def test_occurrences_in_host_order_and_other_prefixes_left_out():
    got = _read(_span("detect/nms", 50, 60), _launch(51, (52, 54), call="cuLaunchKernel"),
                _span("bench/call", 0, 100),
                _span("detect/nms", 10, 20), _launch(11, (12, 13)),
                _launch(30, (31, 38)), prefixes=("detect/",))
    assert list(got) == ["detect/nms"]
    assert [e["device_s"] for e in got["detect/nms"]] == pytest.approx([1e-6, 2e-6])
