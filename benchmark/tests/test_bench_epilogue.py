"""``epilogue_roofline.detect`` on synthetic traces: nothing without the
epilogue kernel, the bound over its time with it."""

import pytest

from benchmark.harness import flops, spec
from benchmark.reference import cfg as ref_cfg

NAME = "void (anonymous namespace)::bias_leaky_kernel<true, unsigned int>(unsigned short*, ...)"


def _ctx(by_name, batch=64, calls=8):
    _, layers = ref_cfg.layers(spec.config("yolov3-amyloid-416")["cfg_path"])
    return {"kind": "detect", "trace": {"by_name": by_name, "device": [("k", 0.0, 1.0)]},
            "steps_traced": calls, "layers": layers, "model_size": 416, "batch": batch}


@pytest.mark.parametrize("by_name", [{}, {"void at::native::elementwise_kernel<128, 4>": 0.06},
                                     {"void fused_residual_block_kernel<128, 64>": 0.08}])
def test_nothing_without_the_kernel(by_name):
    assert spec.reader("epilogue_roofline.detect")(_ctx(by_name)) is None


def test_the_share_over_the_kernels_time_a_call():
    read = spec.reader("epilogue_roofline.detect")
    # the 29 convs outside the residual units write 16,558,113 elements an
    # image at 416: at B=64, 4.24 GB read and written in bf16, 1.27 ms
    bound = 4 * 64 * 16_558_113 / flops.PEAKS["hbm_bytes_per_s"]
    assert bound == pytest.approx(1.2653e-3, rel=1e-4)
    # 8 calls, the kernel twice as long as its bound, its time split over two names
    ctx = _ctx({NAME: 8 * bound, NAME.replace("true", "false"): 8 * bound,
                "void at::native::vectorized_elementwise_kernel<8>": 1.0})
    assert read(ctx) == pytest.approx(50.0)
    assert read({**ctx, "kind": "train"}) is None
