"""loss_device_ms.train (targets and loss, ``ops/targets.py``,
``ops/loss.py``; device trace): device time of the kernels launched under
the step's ``train/loss`` range (its forward only: the backward runs on
autograd's thread), per micro-step."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    occ = ctx["trace"]["ranges"].get("train/loss")
    return sum(occ) / ctx["steps_traced"] * 1e3 if occ else None
