"""Whole runs of the harness on the CPU at a tiny size (the card's check
skipped by calling `run.execute` directly): a sound run is correct, and
each fault that a cell can have, planted in the program, and the control
come out not correct under the cells' own limits."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import run
from perfbench.harness import spec, training

ROOT = spec.HERE.parent
TINY = {"img_size": 32, "batch": 4, "pool_batches": 3, "profiled_steps": 2}
SEED = 2 ** 31 + 977


def _cell(name):
    cell = spec.load_cell(name)
    cell["params"].update(TINY)
    return cell


def _execute(name, trace=False):
    return run.execute(_cell(name), SEED, 1.0, trace, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("name", ["ade_semantic.train_256",
                                  "city_instance.train_128"])
def test_sound_training_run_is_correct(name):
    out = _execute(name)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_img_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_sound_training_run_is_traced():
    out = _execute("ade_semantic.train_256", trace=True)
    assert out["correct"], out["checks"]
    assert "launches_per_step.train" in out["metrics"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_state_left_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    out = _execute("ade_semantic.train_256")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["ade_semantic.train_256",
                                  "city_instance.train_128"])
def test_half_the_batch_left_out_is_not_correct(monkeypatch, name):
    from maskunet_tpu_torch.train import step as step_lib
    whole = step_lib.cross_entropy

    def half(logits, labels, ignore_index=None, group=None):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n], ignore_index, group)

    monkeypatch.setattr(step_lib, "cross_entropy", half)
    assert not _execute(name)["correct"]


@pytest.mark.parametrize("name", ["ade_semantic.train_256",
                                  "city_instance.train_128"])
def test_training_control_fp8_is_not_correct(name):
    cell = _cell(name)
    r = training.run(cell, SEED, 0.2, False, "cpu", lambda **_: None)
    numbers = r["check"](quant="fp8")
    assert any(numbers[k] > v for k, v in cell["limits"].items()), numbers


def test_unknown_kind_is_refused():
    cell = _cell("ade_semantic.train_256")
    cell["kind"] = "no_such_loop"
    with pytest.raises(ValueError, match="no_such_loop"):
        spec.mix(cell)


def _run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "ade_semantic.train_256", "--seed", "1", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _printed_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_exits_nonzero_without_a_card():
    proc = _run_py(ROOT)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_exits_nonzero_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_card_sampler_reports_its_readings_or_why_not():
    from perfbench.harness import card
    sampler = card.Sampler(every_s=0.01)
    sampler.start()
    time.sleep(0.05)
    out = sampler.stop()
    assert "nvml" in out or (out["samples"] >= 1 and out["sm_mhz"][0] > 0)
