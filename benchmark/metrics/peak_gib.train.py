"""peak_gib.train (device; program counter): ``max_memory_allocated`` over
the window, in GiB."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["window"]["peak_bytes"]:
        return None
    return ctx["window"]["peak_bytes"] / 2 ** 30
