"""fwd_bwd_device_ms.train (forward and backward: ``models/darknet.py``,
autograd, cuDNN; device trace): device busy time per micro-step less the
kernels under ``train/augment``, ``train/loss`` and ``train/optimizer``."""

RANGES = ("train/augment", "train/loss", "train/optimizer")


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["trace"]["device"]:
        return None
    tr = ctx["trace"]
    other = sum(sum(tr["ranges"].get(r, [])) for r in RANGES)
    return (tr["busy_s"] - other) / ctx["steps_traced"] * 1e3
