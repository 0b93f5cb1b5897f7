"""mfu.train (the whole step; host clock): 3 × the forward conv FLOPs of
every image of the window at its micro-step's size, over the window's
seconds, against the float32 peak outside the tensor cores (the step runs
with TF32 off)."""

from benchmark.harness import flops


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["window"]["items"]:
        return None
    w = ctx["window"]
    done = ctx["batch"] * sum(flops.train_flops(ctx["layers"], s) for s in w["sizes"])
    return 100.0 * done / w["seconds"] / flops.PEAKS["f32_flops"]
