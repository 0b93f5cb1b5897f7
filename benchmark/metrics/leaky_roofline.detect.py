"""leaky_roofline.detect (the library convs' bias-and-leaky epilogue,
``kernels/bias_leaky.py:bias_leaky``, ``csrc/bias_leaky.cu``; device trace)
on a graph with Mish convs: the least time of the epilogue of every conv
that is not Mish and lies outside the residual units (the leaky convs and
the linear heads, which the same kernel takes) at the HBM peak, bound by
bytes (each conv's bf16 output read once and written once; the bias is left
out), over the device time a call of the kernels named
``bias_leaky_kernel``.  YOLOv4's 38 such convs move 4.56 GB at B=64 and
608, 1.36 ms.  :mod:`epilogue_roofline.detect` reads the same kernel on a
graph without Mish, where every conv outside the units takes it.  A trace
without that kernel, or a graph without Mish convs, gives nothing."""

from benchmark.harness import flops
from benchmark.reference.cfg import residual_units

KERNEL = "bias_leaky_kernel"   # a part of the kernel's name in the trace


def leaky_bytes(layers, img: int, batch: int) -> float:
    """Bytes of the epilogues of the convs that are not Mish, outside the
    residual units; 0 for a graph without Mish convs."""
    convs = [i for i, layer in enumerate(layers) if layer["type"] == "conv"]
    if not any(layers[i].get("act") == "mish" for i in convs):
        return 0.0
    inside = {j for i in residual_units(layers) for j in (i, i + 1)}
    sizes = flops.spatial_sizes(layers, img)
    return sum(2.0 * 2 * batch * sizes[i] ** 2 * layers[i]["cout"] for i in convs
               if layers[i]["act"] != "mish" and i not in inside)


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    t = sum(s for n, s in ctx["trace"]["by_name"].items() if KERNEL in n) / ctx["steps_traced"]
    nbytes = leaky_bytes(ctx["layers"], ctx["model_size"], ctx["batch"])
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / flops.PEAKS["hbm_bytes_per_s"] / t
