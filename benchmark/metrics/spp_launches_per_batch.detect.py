"""spp_launches_per_batch.detect (the SPP block's pools and route,
``kernels/spp_pool.py``, in ``models/darknet.py``; device trace): the
device records a call of the kernels that ``spp_device_ms.detect`` times
(names holding ``max_pool`` or ``spp_pool_kernel``): 3 where YOLOv4's
pools run as library max-pools, 1 where the block is one pass.  A trace
without any of them gives nothing."""

KERNELS = ("max_pool", "spp_pool_kernel")   # parts of the kernels' names in the trace


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    n = sum(1 for name, _, _ in ctx["trace"]["device"] if any(k in name for k in KERNELS))
    if n == 0:
        return None
    return n / ctx["steps_traced"]
