"""Host ms a training step, untraced: the mean of the program's
`train.step` spans closed with no profiler running, the process's first
left out. Near the window's wall step the host paces the window; well
below it the card does."""

from perfbench.harness import spans


def read(ctx):
    t = spans.step_total(ctx)
    if t is None or t.count < 2:
        return None
    return (t.total_ns - t.first_ns) / (t.count - 1) / 1e6
