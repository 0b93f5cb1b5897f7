"""optimizer_device_ms.train (optimizer, ``parallel/steps.py``: the Adam
apply and the BN running statistics; device trace): device time of the
kernels launched under ``train/optimizer`` in the traced micro-steps that
apply, per applying micro-step."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    occ = ctx["trace"]["ranges"].get("train/optimizer") or []
    applies = ctx["applies_traced"]
    mine = [s for s, a in zip(occ, applies) if a]
    if len(occ) != len(applies) or not mine:
        return None
    return sum(mine) / len(mine) * 1e3
