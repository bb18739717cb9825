"""Idle device time a training step under the span `feed.wait`: the
consumer waiting on the prefetcher's queue (`harness/spans.py` splits
the profiled stretch's idle time)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "feed")
