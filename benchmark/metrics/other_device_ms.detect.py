"""other_device_ms.detect (the library convolutions, heads, decode, NMS and
rescale outside K1 and K2: ``models/darknet.py``, ``models/heads.py``,
``ops/nms.py``, ``ops/boxes.py``; device trace): device busy time a call
less K1's and K2's kernels."""

from benchmark.harness import flops


def read(ctx):
    if ctx.get("kind") != "detect" or not ctx["trace"]["device"]:
        return None
    tr = ctx["trace"]
    k12 = flops.kernel_seconds(tr, "K1") + flops.kernel_seconds(tr, "K2")
    return (tr["busy_s"] - k12) / ctx["steps_traced"] * 1e3
