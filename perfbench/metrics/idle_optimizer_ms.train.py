"""Idle device time a training step under the span `train.optimizer`:
AdamW's step, `zero_grad` and the schedule (`harness/spans.py` splits
the profiled stretch's idle time)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "optimizer")
