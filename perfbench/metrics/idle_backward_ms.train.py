"""Idle device time a training step under the span `train.backward`:
`torch.autograd.grad` and the zero-fill of unused gradients
(`harness/spans.py` splits the profiled stretch's idle time)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "backward")
