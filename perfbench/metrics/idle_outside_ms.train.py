"""Idle device time a training step under no span of the program: the
loop's lagged read of the metrics and the caller's own code
(`harness/spans.py` splits the profiled stretch's idle time)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "outside")
