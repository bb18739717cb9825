"""Short runs of every cell on the card (`-m cuda`; they skip without
one): each prints a correct result with the result line's keys."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 4099), "--seconds", "2", "--trace", str(trace)],
        cwd=spec.HERE.parent, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0 and "breakdown" in out
