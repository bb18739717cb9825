"""Device ms a training step in the elementwise, reduction and copy
families (`harness/trace.kernel_kind`): the f32 BatchNorm and LayerNorm
passes, casts, the loss and AdamW's foreach kernels."""

from perfbench.harness.trace import kernel_kind

FAMILIES = ("elementwise", "reduction", "copy")


def read(ctx):
    if ctx.result["kind"] != "training" or ctx.trace is None:
        return None
    us = ctx.trace.per_call_us(lambda n: kernel_kind(n) in FAMILIES)
    return None if us is None else us / 1e3
