"""The trace reader on a hand-made Chrome trace."""

import pytest

from perfbench.harness.trace import SPAN, Trace


def _events():
    ev = [{"cat": "user_annotation", "name": SPAN, "ts": 0, "dur": 10,
           "tid": 1},
          {"cat": "user_annotation", "name": SPAN, "ts": 20, "dur": 10,
           "tid": 1},
          {"cat": "cpu_op", "name": "aten::conv", "ts": 0, "dur": 30,
           "tid": 1},
          {"cat": "cpu_op", "name": "aten::copy_", "ts": 12, "dur": 6,
           "tid": 1},
          {"cat": "cpu_op", "name": "other_thread", "ts": 0, "dur": 50,
           "tid": 2}]
    # two launches a span, one outside any span (tid 2)
    for corr, (ts, tid) in enumerate([(1, 1), (5, 1), (21, 1), (25, 1),
                                      (15, 2)]):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": ts, "dur": 1, "tid": tid,
                   "args": {"correlation": corr}})
    kernels = [("fwd_nomax_wgmma", 2, 4), ("elementwise_kernel", 6, 2),
               ("fwd_nomax_wgmma", 22, 4), ("elementwise_kernel", 26, 4),
               ("Memcpy HtoD", 40, 5)]
    for corr, (name, ts, dur) in enumerate(kernels):
        ev.append({"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})
    return ev


def test_calls_ops_busy_and_gaps():
    t = Trace(_events())
    assert t.calls == 2
    assert t.launches_per_call() == 2
    assert t.per_call_us(lambda n: "fwd_nomax" in n) == 4
    assert t.per_call_us(lambda n: "bwd_" in n) is None
    assert t.window_us == 50
    assert t.busy_us == 4 + 2 + 4 + 4 + 5
    gaps = dict(t.gaps and [(n, 0) for n, _ in t.gaps])
    # the hole at 8-22 starts inside aten::conv on the launching thread
    assert "aten::conv" in gaps and "other_thread" not in gaps
    b = t.breakdown()
    assert b["device_ops"][0] == ["fwd_nomax_wgmma", pytest.approx(8e-6)]
    assert len(b["idle_gaps"]) <= 10
