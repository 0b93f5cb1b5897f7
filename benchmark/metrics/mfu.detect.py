"""mfu.detect (the whole call; host clock): the conv FLOPs of every tile
done in the window, over the window's seconds, against the bf16 peak."""

from benchmark.harness import flops


def read(ctx):
    if ctx.get("kind") != "detect" or not ctx["window"]["items"]:
        return None
    w = ctx["window"]
    done = flops.conv_flops(ctx["layers"], ctx["model_size"]) * w["items"]
    return 100.0 * done / w["seconds"] / flops.PEAKS["bf16_flops"]
