"""Idle device time a training step in `train.step` under none of its
child spans: the batch move, the masks, the mIoU, the all-reduces and
the metrics (`harness/spans.py` splits the profiled stretch's idle
time)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "step_self")
