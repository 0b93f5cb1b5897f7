"""spp_device_ms.detect (the SPP block's pools and route,
``kernels/spp_pool.py``, ``csrc/spp_pool.cu``, in ``models/darknet.py``;
device trace): the device ms a call of the kernels that pool it, whatever
implements them: the library's max-pools (names holding ``max_pool``) or
the one-pass kernel ``spp_pool_kernel``.  YOLOv4 at B=64 and 608: three
pools of 5, 9 and 13 over 64x512x19x19 in bf16.  A trace without any of
those kernels (a graph without max-pools) gives nothing."""

KERNELS = ("max_pool", "spp_pool_kernel")   # parts of the kernels' names in the trace


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    t = sum(s for n, s in ctx["trace"]["by_name"].items() if any(k in n for k in KERNELS))
    if t <= 0:
        return None
    return t / ctx["steps_traced"] * 1e3
