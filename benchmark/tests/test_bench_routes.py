"""``route_copy_ms.detect`` on synthetic traces: the routes' copies
(``CatArrayBatchedCopy``) a call, a trace without them, and a training
trace."""

import pytest

from benchmark.harness import spec

CAT = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_alig2_contig<"
       "at::native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 4, 128, 1>(...)")
OTHER = "void (anonymous namespace)::bias_mish_kernel<true, false, unsigned int>(...)"


def _ctx(records, calls=8, kind="detect"):
    by_name = {}
    for name, a, b in records:
        by_name[name] = by_name.get(name, 0.0) + b - a
    return {"kind": kind, "trace": {"by_name": by_name, "device": records},
            "steps_traced": calls}


def _records(names_and_ms, calls=8):
    out, t = [], 0.0
    for _ in range(calls):
        for name, ms in names_and_ms:
            out.append((name, t, t + ms / 1e3))
            t += ms / 1e3 + 1e-5
    return out


def test_the_copies_read_as_their_device_ms_a_call():
    # the parent of YOLOv4's joins: nine copies a call, 2.91 ms
    ctx = _ctx(_records([(CAT, 1.5), (OTHER, 1.0), (CAT, 0.5), *[(CAT, 0.13)] * 7]))
    assert spec.reader("route_copy_ms.detect")(ctx) == pytest.approx(2.91)
    # the four copies left
    ctx = _ctx(_records([(OTHER, 1.0), *[(CAT, 0.12)] * 4]))
    assert spec.reader("route_copy_ms.detect")(ctx) == pytest.approx(0.48)


def test_nothing_without_a_copy_or_outside_detection():
    read = spec.reader("route_copy_ms.detect")
    assert read(_ctx(_records([(OTHER, 1.0)]))) is None
    assert read(_ctx([])) is None
    assert read(_ctx(_records([(CAT, 0.2)]), kind="train")) is None
