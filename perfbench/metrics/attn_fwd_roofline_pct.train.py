"""K2's share of its roofline in training: the six forward launches'
least time over the cell's masks, over the device time a step of the
kernels named below."""

PATTERN = "fwd_nomax"


def read(ctx):
    if ctx.result["kind"] != "training" or ctx.trace is None:
        return None
    us = ctx.trace.per_call_us(lambda n: PATTERN in n)
    if us is None:
        return None
    return 100.0 * ctx.result["bounds"]["fwd"] * 1e6 / us
