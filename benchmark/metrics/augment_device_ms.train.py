"""augment_device_ms.train (augment, ``ops/augment.py``, with the resize;
device trace): device time of the kernels launched under the step's
``train/augment`` range, per micro-step."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    occ = ctx["trace"]["ranges"].get("train/augment")
    return sum(occ) / ctx["steps_traced"] * 1e3 if occ else None
