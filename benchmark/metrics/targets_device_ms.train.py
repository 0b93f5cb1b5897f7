"""targets_device_ms.train (targets and loss: ``ops/targets.py``; device
trace): device time of the kernels launched under the step's
``train/targets`` ranges (one a head, inside ``train/loss``), summed, per
micro-step; nothing on a trace without the range."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    occ = ctx["trace"]["ranges"].get("train/targets")
    return sum(occ) / ctx["steps_traced"] * 1e3 if occ else None
