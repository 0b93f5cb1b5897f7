"""host_enqueue_ms.train (step, ``parallel/steps.py``; host clock): the mean
host time of a micro-step's call, over the window's micro-steps."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["window"]["enqueue_s"]:
        return None
    enq = ctx["window"]["enqueue_s"]
    return sum(enq) / len(enq) * 1e3
