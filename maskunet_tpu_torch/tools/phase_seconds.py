"""Seconds a phase of a script that prints one JSON line per check, as
`chip_smoke.py` does: each stdout line is stamped with the seconds since
the start, and a phase is charged the gaps up to its lines.

    python -m maskunet_tpu_torch.tools.phase_seconds run OUT -- python3 chip_smoke.py
    python -m maskunet_tpu_torch.tools.phase_seconds read OUT [OUT2]

`run` runs the command, writes its stamped stdout to OUT (its stderr
passes through) and prints the table; it exits with the command's code.
`read` prints the table of one stamped file, or of two side by side with
their difference. A line that is no JSON object with a "phase" key is
charged to "(text)", the `kernels` line to "kernels".
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def run(out: str, cmd: list[str]) -> int:
    t0 = time.monotonic()
    with open(out, "w") as f:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                bufsize=1)
        for line in proc.stdout:
            f.write(f"{time.monotonic() - t0:.1f}\t{line}")
            f.flush()
        rc = proc.wait()
        f.write(f"{time.monotonic() - t0:.1f}\trc={rc}\n")
    return rc


def _phase(text: str) -> str:
    try:
        d = json.loads(text)
    except json.JSONDecodeError:
        return "(text)"
    if not isinstance(d, dict):
        return "(text)"
    return d.get("phase", "kernels" if "kernels" in d else "(text)")


def phase_seconds(path: str) -> tuple[dict[str, float], float]:
    """({phase: seconds} in order of first appearance, the total)."""
    seconds: dict[str, float] = {}
    prev = 0.0
    with open(path) as f:
        for line in f:
            stamp, _, text = line.partition("\t")
            t = float(stamp)
            phase = _phase(text)
            seconds[phase] = seconds.get(phase, 0.0) + t - prev
            prev = t
    return seconds, prev


def table(paths: list[str]) -> str:
    runs = [phase_seconds(p) for p in paths]
    names = list(dict.fromkeys(k for s, _ in runs for k in s))
    rows = []
    for name in names + ["total"]:
        vals = [total if name == "total" else s.get(name, 0.0)
                for s, total in runs]
        diff = f" {vals[1] - vals[0]:+8.1f}" if len(vals) == 2 else ""
        rows.append(f"{name:24s}" + "".join(f" {v:8.1f}" for v in vals)
                    + diff)
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("out")
    r.add_argument("command", nargs=argparse.REMAINDER)
    rd = sub.add_parser("read")
    rd.add_argument("paths", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "read":
        if len(args.paths) > 2:
            ap.error("read takes one or two files")
        print(table(args.paths))
        return 0
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        ap.error("run needs a command after --")
    rc = run(args.out, command)
    print(table([args.out]))
    return rc


if __name__ == "__main__":
    sys.exit(main())
