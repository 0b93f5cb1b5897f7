"""launches_per_batch.detect (Detector, ``detectors.py``; device trace):
device operations per call in the checked trace."""


def read(ctx):
    if ctx.get("kind") != "detect" or not ctx["trace"]["device"]:
        return None
    return len(ctx["trace"]["device"]) / ctx["steps_traced"]
