"""idle_share.detect (device; device trace): the share of the traced span,
first device operation to last, in which no operation ran."""


def read(ctx):
    if ctx.get("kind") != "detect" or ctx["trace"]["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["trace"]["span_s"])
