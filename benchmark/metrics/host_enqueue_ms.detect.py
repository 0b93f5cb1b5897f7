"""host_enqueue_ms.detect (Detector, ``detectors.py``; host clock): the
mean host time from entering ``Detector.__call__`` to leaving it, over the
window's calls (the profiled stretch comes after the window)."""


def read(ctx):
    if ctx.get("kind") != "detect" or not ctx["window"]["enqueue_s"]:
        return None
    enq = ctx["window"]["enqueue_s"]
    return sum(enq) / len(enq) * 1e3
