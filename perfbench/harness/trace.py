"""Reading a `torch.profiler` trace of the profiled stretch.

The stretch runs under `torch.profiler.profile` (CPU and CUDA) with the
harness's own span, `perfbench.call`, around each call into the program
(a training step). The Chrome trace gives the
device operations (kernels, memcpy, memset) with their times, the host's
runtime calls that launched them (matched by correlation id) and the
host's operators.

- Operations of a call: the device operations whose launch lies inside
  one of the call spans; `per_call` divides by the number of spans.
- Busy: the union of all device operations' intervals in the stretch.
- Idle gaps: the longest holes in that union (at most `_NAMED_GAPS`),
  each named by the innermost host operator running at its start on the
  thread that launched the most device work (the dispatching thread).

`kernel_kind` is a frozen copy of `chip_smoke.kernel_kind`: the family of
a device operation by its profiler name.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

SPAN = "perfbench.call"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FWD_TAG = "fwd_nomax"
K4_TAG = "namespace)::bwd_"
_NAMED_GAPS = 200


def kernel_kind(name: str) -> str:
    low = name.lower()
    if FWD_TAG in name:
        return "K1/K2"
    if K4_TAG in name:
        return "K4"
    if any(t in low for t in ("xmma", "cutlass", "nvjet", "gemm", "conv")):
        return "conv_matmul"
    if "reduce_kernel" in name:
        return "reduction"
    if "copy" in low or name.startswith(("Memcpy", "Memset")):
        return "copy"
    if "elementwise" in name:
        return "elementwise"
    return "other"


class Trace:
    """The parsed stretch: `ops` (device operations of the call spans:
    name, start us, duration us), `calls` (spans), `busy_us`, `window_us`,
    `gaps` ([(host op, us)])."""

    def __init__(self, events: list[dict]):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation"
                       and e.get("name") == SPAN)
        device = [e for e in events if e.get("cat") in _DEVICE_CATS
                  and "dur" in e]
        runtime = [e for e in events if e.get("cat") == "cuda_runtime"
                   or e.get("cat") == "cuda_driver"]
        inside = set()
        starts = [s for s, _ in spans]
        for r in runtime:
            i = bisect.bisect_right(starts, r["ts"]) - 1
            if i >= 0 and r["ts"] <= spans[i][1]:
                corr = r.get("args", {}).get("correlation")
                if corr is not None:
                    inside.add(corr)
        self.calls = len(spans)
        self.ops = [(e["name"], e["ts"], e["dur"]) for e in device
                    if e.get("args", {}).get("correlation") in inside]
        # the host operators of the thread that launched the most work
        launcher = collections.Counter(r.get("tid") for r in runtime)
        tid = launcher.most_common(1)[0][0] if launcher else None
        host = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e
                and e.get("tid") == tid]
        every = [e for e in events if "dur" in e and "ts" in e]
        lo = min(e["ts"] for e in every) if every else 0.0
        hi = max(e["ts"] + e["dur"] for e in every) if every else 0.0
        self.window_us = hi - lo
        intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
        merged: list[list[float]] = []
        for s, e in intervals:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_us = sum(e - s for s, e in merged)
        holes = [(merged[i][1], merged[i + 1][0])
                 for i in range(len(merged) - 1)]
        if merged:
            holes = [(lo, merged[0][0])] + holes + [(merged[-1][1], hi)]
        holes = sorted((h for h in holes if h[1] > h[0]),
                       key=lambda h: h[0] - h[1])[:_NAMED_GAPS]
        self.gaps = [(self._host_at(host, s), e - s) for s, e in holes]

    @staticmethod
    def _host_at(host, t) -> str:
        best = None
        for e in host:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best is not None else "no host operator"

    def per_call_us(self, match) -> float | None:
        """Device us a call of the operations whose name `match` accepts;
        None where no such operation ran."""
        hits = [d for n, _, d in self.ops if match(n)]
        if not hits or not self.calls:
            return None
        return sum(hits) / self.calls

    def launches_per_call(self) -> float | None:
        return len(self.ops) / self.calls if self.calls else None

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for name, _, d in self.ops:
            ops[name[:120]] += d / 1e6
        gaps = collections.Counter()
        for name, d in self.gaps:
            gaps[name[:120]] += d / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(10)]}


def profile(body) -> Trace:
    """Run `body()` under the profiler (CPU and CUDA) and parse its trace,
    written to a temporary directory (under TMPDIR) and deleted."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    # the Prefetcher's copy thread started before the profiler
    config = _ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                experimental_config=config) as prof:
        body()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events)
