"""The readings that the comparison's limits are set from, on the card.

    python3 perfbench/tools/readings.py --workload <cell> \\
        [--seeds <n> ...] [--control-seeds <n> ...] [--seconds 2] \\
        [--out <file.jsonl>]

For each of `--seeds`, a run of the cell at its own size (a short window,
the comparison as a run makes it) prints the program's numbers. For each
of `--control-seeds` one run prints the numbers of each of the loop's
`CONTROLS` (`harness/<kind>.py`): for training the reference computed in
fp8 where the program computes in bf16, put in the program's place, and
the fault of half the batch left out of the loss (the mean over the
rest). The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.harness import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    mix = spec.mix(cell)
    sink = open(args.out, "a") if args.out else None

    def emit(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def quiet(**_):
        pass

    for seed in args.seeds:
        r = mix.run(cell, seed, args.seconds, False, args.device, quiet)
        emit(cell=cell["name"], seed=seed, reading="program",
             images_per_s=r["images"] / r["seconds"], **r["check"]())
    for seed in args.control_seeds:
        r = mix.run(cell, seed, args.seconds, False, args.device, quiet)
        for reading, fault in mix.CONTROLS.items():
            emit(cell=cell["name"], seed=seed, reading=reading,
                 **r["check"](**fault))
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
