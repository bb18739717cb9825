"""Device operations (kernels, memcpy, memset) launched inside the
harness's span around a training step, a step, in the profiled stretch."""


def read(ctx):
    if ctx.result["kind"] != "training" or ctx.trace is None:
        return None
    return ctx.trace.launches_per_call()
