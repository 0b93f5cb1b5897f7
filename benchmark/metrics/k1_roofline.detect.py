"""k1_roofline.detect (preprocess K1, ``kernels/preprocess_kernel.py``,
``csrc/resize_normalize.cu``; device trace): the least time of the batch's
resize at the HBM peak, bound by bytes (the sampled uint8 pixels read once,
the bf16 input written once), over K1's device time a call."""

from benchmark.harness import flops


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    t = flops.kernel_seconds(ctx["trace"], "K1") / ctx["steps_traced"]
    if t <= 0:
        return None
    bound = flops.preprocess_bytes(ctx["batch"], ctx["model_size"]) / flops.PEAKS["hbm_bytes_per_s"]
    return 100.0 * bound / t
