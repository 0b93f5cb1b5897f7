"""route_copy_ms.detect (the routes' joins in ``models/darknet.py``; device
trace): the device ms a call of the kernels named ``CatArrayBatchedCopy``,
the library's copies of a ``torch.cat``: the routes that the folded forward
joins with a copy (YOLOv3's two; YOLOv4's routes with an upsample member or
a member that the next conv reads, and before its CSP joins were written in
place, those five too), with the lazy decode's small cats.  A trace without
such a kernel gives nothing."""

KERNEL = "CatArrayBatchedCopy"   # part of the copy kernel's name in the trace


def read(ctx):
    if ctx.get("kind") != "detect":
        return None
    t = sum(s for n, s in ctx["trace"]["by_name"].items() if KERNEL in n)
    if t <= 0:
        return None
    return t / ctx["steps_traced"] * 1e3
