"""Per-op device timings of a profiler trace.

Counterpart of tools/parse_xplane.py, whose name it keeps so that a reader
finds it. The card writes no xplane: the trace is the Chrome trace that
`torch.profiler` exports (`utils/profiling.trace` writes `trace.json`).
The device's events in it are the kernels (`"cat": "kernel"`) and the
memory copies and sets (`gpu_memcpy`, `gpu_memset`); their durations are in
µs. Each CUDA device is one plane, named as JAX names a device plane.

    python -m maskunet_tpu_torch.tools.parse_xplane <trace_dir> [steps]
"""

from __future__ import annotations

import glob
import json
import os
import sys
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_dir: str) -> list[tuple[str, str, float]]:
    """(plane, op name, ms) of every device event of the newest trace under
    `trace_dir`, in the trace's order."""
    paths = glob.glob(os.path.join(trace_dir, "*.json"))
    if not paths:
        raise FileNotFoundError(f"no trace.json under {trace_dir}")
    newest = max(paths, key=os.path.getmtime)
    with open(newest) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        device = ev.get("args", {}).get("device", ev.get("pid"))
        out.append((f"/device:GPU:{device}", ev["name"],
                    float(ev.get("dur", 0.0)) / 1e3))    # µs -> ms
    return out


def op_times(trace_dir: str) -> dict[str, dict[str, float]]:
    """{plane_name: {op_name: total_ms}} for the CUDA device planes."""
    out: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for plane, name, ms in device_events(trace_dir):
        out[plane][name] += ms
    return {plane: dict(agg) for plane, agg in out.items()}


def main() -> None:
    trace_dir = sys.argv[1]
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    for plane, agg in op_times(trace_dir).items():
        print(f"== {plane} ==")
        total = sum(agg.values())
        for name, ms in sorted(agg.items(), key=lambda kv: -kv[1])[:30]:
            print(f"{ms / steps:9.3f} ms/step {100 * ms / total:5.1f}%  "
                  f"{name[:90]}")
        print(f"{total / steps:9.3f} ms/step total device time")


if __name__ == "__main__":
    main()
