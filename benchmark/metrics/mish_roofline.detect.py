"""mish_roofline.detect (the library convs' bias-and-Mish epilogue,
``kernels/bias_leaky.py:bias_mish``, ``csrc/bias_leaky.cu``; device trace):
the least time of the epilogue of every Mish conv at the HBM peak, bound by
bytes (each conv's bf16 output read once and written once; the bias is left
out), over the device time a call of the kernels named
``bias_mish_kernel``.  At B=64 and 608 YOLOv4's 72 Mish convs move 24.27
GB, 7.25 ms.  A trace without that kernel, or a graph without Mish convs,
gives nothing."""

from benchmark.harness import flops

KERNEL = "bias_mish_kernel"   # a part of the kernel's name in the trace


def mish_bytes(layers, img: int, batch: int) -> float:
    """Bytes of the Mish convs' epilogues: the bf16 output of each read
    once and written once."""
    sizes = flops.spatial_sizes(layers, img)
    return sum(2.0 * 2 * batch * sizes[i] ** 2 * layer["cout"]
               for i, layer in enumerate(layers)
               if layer["type"] == "conv" and layer.get("act") == "mish")


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    t = sum(s for n, s in ctx["trace"]["by_name"].items() if KERNEL in n) / ctx["steps_traced"]
    nbytes = mish_bytes(ctx["layers"], ctx["model_size"], ctx["batch"])
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / flops.PEAKS["hbm_bytes_per_s"] / t
