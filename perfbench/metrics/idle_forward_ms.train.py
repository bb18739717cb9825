"""Idle device time a training step under the span `train.forward`: the
forward through the model, the triplet draw and the loss
(`harness/spans.py` splits the profiled stretch's idle time)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "forward")
