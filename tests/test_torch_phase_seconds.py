"""`maskunet_tpu_torch/tools/phase_seconds.py`: the seconds a phase of a
stamped run, and `run` around a command that prints phase lines."""

import json
import sys

from maskunet_tpu_torch.tools import phase_seconds as ps


def test_read_charges_each_phase_its_gaps(tmp_path):
    path = tmp_path / "run.out"
    path.write_text("".join(f"{t}\t{line}\n" for t, line in (
        (1.5, json.dumps({"phase": "device"})),
        (2.0, json.dumps({"phase": "kernel", "case": 1})),
        (4.0, json.dumps({"phase": "kernel", "case": 2})),
        (4.5, "a tool's plain line"),
        (7.0, json.dumps({"kernels": []})),
        (7.5, "rc=0"))))
    seconds, total = ps.phase_seconds(str(path))
    assert seconds == {"device": 1.5, "kernel": 2.5, "(text)": 1.0,
                       "kernels": 2.5}
    assert total == 7.5
    rows = ps.table([str(path), str(path)]).splitlines()
    assert rows[0].split() == ["device", "1.5", "1.5", "+0.0"]
    assert rows[-1].split() == ["total", "7.5", "7.5", "+0.0"]


def test_run_stamps_the_command_and_keeps_its_code(tmp_path, capsys):
    code = ("import json, sys; print(json.dumps({'phase': 'a'})); "
            "sys.exit(3)")
    out = tmp_path / "run.out"
    assert ps.main(["run", str(out), "--", sys.executable, "-c", code]) == 3
    lines = out.read_text().splitlines()
    assert lines[0].split("\t")[1] == '{"phase": "a"}'
    assert lines[-1].endswith("\trc=3")
    assert capsys.readouterr().out.splitlines()[0].split()[0] == "a"
