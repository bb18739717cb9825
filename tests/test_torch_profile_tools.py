"""The port's profiler tools (`maskunet_tpu_torch.tools.parse_xplane` and
`.profile_step`) on the CPU, and every new tool's refusal of a host
without CUDA.

`parse_xplane` reads torch.profiler's Chrome trace: on a hand-written
trace the sums by name and device are exact (durations are binary
fractions of a ms), only the device's events count (kernels, memcpy,
memset), and for the same {plane: {op: ms}} its printed table equals the
JAX tool's (tools/parse_xplane.py) line for line. `profile_step.run` at
16 px writes both traces and returns calls that run.
"""

import json
import os
import shutil
import sys

import pytest
import torch

from maskunet_tpu_torch.tools import (data_bench, fwd_breakdown,
                                      parse_xplane, profile_step,
                                      tpu_kernel_paritycheck,
                                      train_breakdown, training_parity,
                                      trunk_breakdown)

from test_torch_softmax_tools import _load_tool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the model runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _event(name, cat, dur_us, device=0, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": device, "tid": 7,
            "ts": 100.0, "dur": dur_us, "args": {"device": device,
                                                 "stream": 7}}


def _write_trace(path, events):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({"traceEvents": events, "schemaVersion": 1}, f)


def test_op_times_sums_device_events_by_name_and_plane(tmp_path):
    events = [
        _event("fwd_nomax_wgmma<64>", "kernel", 1500.0),
        _event("fwd_nomax_wgmma<64>", "kernel", 250.0),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 125.0),
        _event("Memset (Device)", "gpu_memset", 62.5),
        _event("bwd_wgmma<64>", "kernel", 3000.0, device=1),
        # host-side events and instants are not the device's
        _event("aten::mm", "cpu_op", 9000.0),
        _event("cudaLaunchKernel", "cuda_runtime", 9000.0),
        _event("fwd_nomax_wgmma<64>", "kernel", 9000.0, ph="i"),
    ]
    _write_trace(str(tmp_path), events)
    got = parse_xplane.op_times(str(tmp_path))
    assert got == {
        "/device:GPU:0": {"fwd_nomax_wgmma<64>": 1.75,
                          "Memcpy HtoD (Pageable -> Device)": 0.125,
                          "Memset (Device)": 0.0625},
        "/device:GPU:1": {"bwd_wgmma<64>": 3.0},
    }
    assert len(parse_xplane.device_events(str(tmp_path))) == 5
    with pytest.raises(FileNotFoundError, match="no trace.json"):
        parse_xplane.op_times(str(tmp_path / "empty"))


def test_main_prints_the_jax_tools_table(monkeypatch, capsys):
    """For the same op times, both mains print the same lines: the top 30
    ops a step by share, the names cut to 90 characters, the total."""
    jax_tool = _load_tool("parse_xplane")
    times = {"/device:GPU:0": {f"kernel_{i}_" + "x" * (i * 7): 0.5 * i + 0.25
                               for i in range(40)},
             "/device:GPU:1": {"only": 2.0}}
    monkeypatch.setattr(parse_xplane, "op_times", lambda d: times)
    monkeypatch.setattr(jax_tool, "op_times", lambda d: times)
    monkeypatch.setattr(sys, "argv", ["parse_xplane", "unused", "3"])
    parse_xplane.main()
    port = capsys.readouterr().out.splitlines()
    jax_tool.main()
    want = capsys.readouterr().out.splitlines()
    assert port == want
    assert len(port) == (1 + 30 + 1) + (1 + 1 + 1)


def test_profile_step_run_writes_both_traces(tmp_path):
    res = profile_step.run(1, str(tmp_path), 1, img_size=16, device="cpu")
    for phase in ("fwd", "train"):
        assert res[phase] == str(tmp_path / phase)
        assert os.path.isfile(os.path.join(res[phase], "trace.json"))
        # the CPU runs the plain versions: no kernel launched, no device
        # event in the trace
        assert res["launches"][phase] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
        assert parse_xplane.op_times(res[phase]) == {}
    assert res["calls"]["fwd"]().shape == (1, 16, 16, 150)
    assert torch.isfinite(res["calls"]["train"]())
    for phase in ("fwd", "train"):
        shutil.rmtree(res[phase])


@pytest.mark.parametrize("tool", [
    profile_step, data_bench, training_parity, tpu_kernel_paritycheck,
    fwd_breakdown, train_breakdown, trunk_breakdown],
    ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_refuse_a_host_without_cuda(tool, monkeypatch):
    """Without `--device cpu` each tool exits naming CUDA before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
