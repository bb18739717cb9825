"""K4's share of its roofline: the six backward launches' least time over
the cell's masks, over the device time a step of the kernels named
below."""

PATTERN = "namespace)::bwd_"


def read(ctx):
    if ctx.result["kind"] != "training" or ctx.trace is None:
        return None
    us = ctx.trace.per_call_us(lambda n: PATTERN in n)
    if us is None:
        return None
    return 100.0 * ctx.result["bounds"]["bwd"] * 1e6 / us
