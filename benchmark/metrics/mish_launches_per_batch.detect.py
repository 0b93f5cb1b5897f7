"""mish_launches_per_batch.detect (the bias-and-Mish epilogue,
``kernels/bias_leaky.py:bias_mish``; program counter): the rise of
``bias_mish.launches`` over the traced calls, per call: 72 for YOLOv4's
Mish convs, each through the epilogue once.  Nothing where the run did not
count it (a program without the counter)."""


def read(ctx):
    if ctx.get("kind") != "detect" or ctx.get("mish_launches") is None:
        return None
    return ctx["mish_launches"] / ctx["steps_traced"]
