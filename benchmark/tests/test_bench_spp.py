"""``spp_device_ms.detect`` and ``spp_launches_per_batch.detect`` on
synthetic traces: the library's max-pools (YOLOv4's SPP layer by layer),
the one-pass kernel, and a trace with neither."""

import pytest

from benchmark.harness import spec

POOL = ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16, float>"
        "(c10::BFloat16 const*, ...)")
SPP = "void (anonymous namespace)::spp_pool_kernel<true>(unsigned short const*, ...)"
OTHER = "void (anonymous namespace)::bias_mish_kernel<true, unsigned int>(unsigned short*, ...)"


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


def test_the_library_pools_read_as_three_launches_and_their_time():
    # the parent: three pools a call, 0.30, 0.75 and 1.65 ms
    ctx = _ctx(_records([(POOL, 0.30), (OTHER, 1.0), (POOL, 0.75), (POOL, 1.65)]))
    assert spec.reader("spp_device_ms.detect")(ctx) == pytest.approx(2.70)
    assert spec.reader("spp_launches_per_batch.detect")(ctx) == 3


def test_the_one_pass_kernel_reads_as_one_launch():
    ctx = _ctx(_records([(OTHER, 1.0), (SPP, 0.05)]))
    assert spec.reader("spp_device_ms.detect")(ctx) == pytest.approx(0.05)
    assert spec.reader("spp_launches_per_batch.detect")(ctx) == 1


@pytest.mark.parametrize("name", ["spp_device_ms.detect", "spp_launches_per_batch.detect"])
def test_nothing_without_either(name):
    read = spec.reader(name)
    assert read(_ctx(_records([(OTHER, 1.0)]))) is None
    assert read(_ctx([])) is None
    assert read(_ctx(_records([(SPP, 0.05)]), kind="train")) is None
