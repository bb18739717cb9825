"""Share of the profiled stretch of training steps in which no device
operation ran."""


def read(ctx):
    t = ctx.trace
    if ctx.result["kind"] != "training" or t is None or not t.window_us:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
