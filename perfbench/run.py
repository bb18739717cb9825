"""The benchmark of `maskunet_tpu_torch` on NVIDIA H100 cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. One run is one process: it sets up the cell
(`BENCHMARK.json`'s `workloads`, found at `perfbench/workloads/<cell>.json`),
warms its shapes, measures for `--seconds`, then compares what the timed
path produced with the plain reference (`perfbench/reference/`) and
prints, as the last line of its standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics` and `device` (with `--trace
1` also `breakdown`), and last `checks`: each number compared beside its
limit. The same numbers end its standard error. With `--trace 0` the
metrics are the cell's end-to-end ones; with `--trace 1` the run then
profiles a short stretch after the window and the metrics are the cell's
per-layer ones. The loop that runs a cell's traffic is the module its
mix's `kind` names (`spec.mix`). Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits 1.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench.harness import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "maskunet_tpu")


class Context:
    """What a metric's reader sees: the cell, the loop's result, the
    parsed trace (None without `--trace 1`), the set-up seconds."""

    def __init__(self, cell, result, setup_s):
        self.cell, self.result, self.setup_s = cell, result, setup_s
        self.trace = result.get("trace")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _log(**kw) -> None:
    print(json.dumps(kw, default=str), flush=True)


def execute(cell: dict, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: float = T_START) -> dict:
    """One run of `cell` (`spec.load_cell`'s dict); returns the result's
    object (without printing it)."""
    mix = spec.mix(cell)
    _log(cell=cell["name"], config=cell["config_name"],
         traffic=cell["traffic"], traffic_params=cell["params"], seed=seed,
         seconds=seconds, trace=trace)
    result = mix.run(cell, seed, seconds, trace, device, _log)
    setup_s = result["window_start"] - t_start
    peak = result["memory_peak_bytes"]
    _log(memory_peak_gib=peak / 2 ** 30)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    numbers = result["check"]()
    checks, correct = {}, result["failed"] == 0
    for name, limit in cell["limits"].items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        correct = correct and math.isfinite(value) and value <= limit
    _log(compared={k: v for k, v in numbers.items() if k not in checks})

    bench = spec.benchmark()
    e2e, layer = spec.cell_metrics(bench, cell["name"])
    ctx = Context(cell, result, setup_s)
    metrics = {}
    for entry in (layer if trace else e2e):
        read = spec.reader(entry["name"],
                           "metrics" if trace else "end_to_end")
        value = read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": dev}
    if trace and result["trace"] is not None:
        t = result["trace"]
        dev["busy_s"] = t.busy_us / 1e6
        dev["window_s"] = t.window_us / 1e6
        out["breakdown"] = t.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark measures the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    from maskunet_tpu_torch.core.device import card_name
    _log(card=card_name(torch.device("cuda", 0)), torch=torch.__version__,
         cuda=torch.version.cuda)
    out = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
