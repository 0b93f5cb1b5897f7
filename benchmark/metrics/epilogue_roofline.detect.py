"""epilogue_roofline.detect (the library convs' bias-and-leaky epilogue,
``kernels/bias_leaky.py``, ``csrc/bias_leaky.cu``; device trace): the least
time of the epilogue of every conv outside the residual units at the HBM
peak, bound by bytes (each conv's bf16 output read once and written once;
the bias is left out), over the epilogue kernel's device time a call.  A
trace without that kernel (a program that adds the bias and the leaky as
PyTorch elementwise passes) gives nothing."""

from benchmark.harness import flops
from benchmark.reference.cfg import residual_units

KERNEL = "bias_leaky_kernel"   # a part of the kernel's name in the trace


def epilogue_bytes(layers, img: int, batch: int) -> float:
    """Bytes of the epilogues of the convs outside the residual units: the
    bf16 output of each read once and written once."""
    inside = {j for i in residual_units(layers) for j in (i, i + 1)}
    sizes = flops.spatial_sizes(layers, img)
    return sum(2.0 * 2 * batch * sizes[i] ** 2 * layer["cout"]
               for i, layer in enumerate(layers) if layer["type"] == "conv" and i not in inside)


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    t = sum(s for n, s in ctx["trace"]["by_name"].items() if KERNEL in n) / ctx["steps_traced"]
    if t <= 0:
        return None
    nbytes = epilogue_bytes(ctx["layers"], ctx["model_size"], ctx["batch"])
    return 100.0 * nbytes / flops.PEAKS["hbm_bytes_per_s"] / t
