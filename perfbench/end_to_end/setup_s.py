"""Seconds from the process's start to the window's: import, the CUDA
context, the kernels' build where the checkout has none yet, weights,
masks, plans, inputs and warm-up."""


def read(ctx):
    return ctx.setup_s
