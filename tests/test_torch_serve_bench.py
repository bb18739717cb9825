"""The port's serving load tools on the CPU: `tools/serve_bench.py` (HTTP
load from client processes) and `tools/serve_breakdown.py` (the A/B/C
split), at 16 px with few requests, against the JAX tools' output keys;
and every tool of this slice refusing a host without CUDA unless it is
given `--device cpu`.

serve_bench runs in a subprocess with a timeout, as a user runs it. Its
clients must never import torch (each reports `"torch" in sys.modules`,
summed into `client_imports_torch`): they start with
CUDA_VISIBLE_DEVICES="" and run the tool's file, whose top level imports
the standard library and numpy only.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from maskunet_tpu_torch.tools import (mfu_report, res256_bench,
                                      serve_bench, serve_breakdown)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tools/serve_bench.py:158-171
JAX_BENCH_KEYS = {"requests", "concurrency", "client_procs",
                  "response_format", "req_per_sec", "failed_requests",
                  "p50_ms", "p99_ms", "avg_batch_fill", "model_ms_ema"}
PORT_BENCH_KEYS = {"card", "kernel_launches", "batches",
                   "client_imports_torch", "setup_s"}
# tools/serve_breakdown.py:316-320
JAX_BREAKDOWN_KEYS = {"model_img_s", "batcher_req_s", "stage_us", "cores"}
STAGES = {"jpeg_decode", "cvt_resize", "png_encode", "raw_tobytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the model runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench(*args) -> dict:
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "maskunet_tpu_torch.tools.serve_bench", "8",
         "2", "2", "--img", "16", "--device", "cpu", *args],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("raw", [False, True])
def test_serve_bench_keys_and_clients(raw):
    out = _bench(*(["--raw"] if raw else []))
    assert set(out) == JAX_BENCH_KEYS | PORT_BENCH_KEYS
    assert out["response_format"] == ("raw" if raw else "png")
    assert (out["requests"], out["concurrency"], out["client_procs"]) == \
        (8, 2, 2)
    assert out["failed_requests"] == 0
    assert out["req_per_sec"] > 0 and 0 < out["p50_ms"] <= out["p99_ms"]
    assert 0 < out["avg_batch_fill"] <= 1
    # 8 timed requests and a warm-up post from each client went through
    # the batcher; the CPU runs K1's plain version, which counts nothing
    assert out["batches"] >= 2 and out["setup_s"] > 0
    assert out["kernel_launches"] == {"K1": 0, "K3": 0}
    assert out["client_imports_torch"] is False
    assert out["card"] is None


def test_serve_breakdown_keys(capsys, monkeypatch):
    """The three stages at 16 px with few iterations: the JAX tool's
    keys."""
    for name, n in (("A_ITERS", 2), ("B_REQUESTS", 16), ("C_ITERS", 3)):
        monkeypatch.setattr(serve_breakdown, name, n)
    out = serve_breakdown.main(["8", "4", "--img", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("A. model-only ceiling")
    assert json.loads(lines[-1]) == out
    assert set(out) == JAX_BREAKDOWN_KEYS | {"card"}
    assert set(out["stage_us"]) == STAGES
    assert out["model_img_s"] > 0 and out["batcher_req_s"] > 0
    assert out["cores"] == os.cpu_count() and out["card"] is None


@pytest.mark.parametrize("main, argv", [
    (mfu_report.main, []), (serve_breakdown.main, []),
    (serve_bench.main, []), (res256_bench.main, ["--batches", "1"])])
def test_tools_refuse_a_host_without_cuda(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        main(argv)
