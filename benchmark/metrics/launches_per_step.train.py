"""launches_per_step.train (step, ``parallel/steps.py``; device trace):
device operations per micro-step in the checked trace."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["trace"]["device"]:
        return None
    return len(ctx["trace"]["device"]) / ctx["steps_traced"]
