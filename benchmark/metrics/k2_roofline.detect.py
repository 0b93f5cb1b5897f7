"""k2_roofline.detect (residual units K2, ``kernels/conv_block.py``,
``csrc/conv_block.cu``; device trace): the larger of the 23 units' bf16
operations at the bf16 peak and their bytes at the HBM peak, at the cell's
shapes, over K2's device time a call.  At B=64 and 416 the operations bind."""

from benchmark.harness import flops


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    t = flops.kernel_seconds(ctx["trace"], "K2") / ctx["steps_traced"]
    if t <= 0:
        return None
    ops, nbytes = flops.residual_unit_bound(ctx["layers"], ctx["model_size"], ctx["batch"])
    bound = max(ops / flops.PEAKS["bf16_flops"], nbytes / flops.PEAKS["hbm_bytes_per_s"])
    return 100.0 * bound / t
