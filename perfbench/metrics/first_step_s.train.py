"""Seconds of the process's first `train.step` span: lazy CUDA, cuBLAS
and cuDNN set-up and kernel loading, inside `setup_s`."""

from perfbench.harness import spans


def read(ctx):
    t = spans.step_total(ctx)
    return None if t is None else t.first_ns / 1e9
