"""The port's attention microbench and sweeps, `lane_ab`,
`bf16_validation`, the data-fraction sweep and its plot, `plateau_bands`
and the queue scripts (`maskunet_tpu_torch.tools`), on the CPU.

- `attn_microbench`, `fwd_sweep`, `bwd_sweep` and `lane_ab` run on small
  shapes with the kernels' plain versions; the sweeps' swap of the
  wrappers' entry lookup (`fwd_sweep.entry_swap`) hands a variant's entry
  to the wrapper and restores the committed lookup after; the `source`
  row takes the committed library's entries and builds nothing.
- `bf16_validation.parity_ok` gives the verdict of JAX's tool
  (tools/bf16_validation.py's main, loaded by path, its `run` replaced by
  hand-made rows) on rows either side of each bound.
- `run_fraction_sweep` on a fake COCO layout (coco_panoptic at 16 px,
  batch 2, one epoch, fractions 0.5 and 1.0) appends one row a fraction
  with exactly the keys of the JAX tool's rows (its main run with `train`
  and the evaluator replaced by stubs, so no JAX model is compiled);
  `plot_sweep` draws the file.
- `plateau_bands.build_comparison` equals JAX's on copies of the
  committed recipes_plateau.json and recipes_e2e.json, and `main`
  rewrites a copy as JAX's `main` rewrites another.
- `bash -n` passes on both queue scripts, and each module they run
  resolves.
- Every card tool refuses a host without CUDA unless given `--device
  cpu`.
One torch thread while a tool runs.
"""

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from maskunet_tpu.tasks import evaluators as jev
from maskunet_tpu.train import loop as jloop
from maskunet_tpu_torch.ops import flash_kernels as fk
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.tools import (attn_microbench, bf16_validation,
                                      bwd_sweep, fwd_sweep, lane_ab,
                                      plateau_bands, plot_sweep,
                                      run_fraction_sweep)
from maskunet_tpu_torch.tools import make_fake_dataset as tfake

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "maskunet_tpu_torch", "tools")
CARD_TOOLS = ("remat_ab", "infer_ab", "plan_ab", "opt_ab", "quant_ab",
              "conv_ab", "conv_model_ab", "attn_microbench", "fwd_sweep",
              "bwd_sweep", "bf16_validation", "lane_ab")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name, monkeypatch, tmp_path):
    """tools/<name>.py imported by path, JAX's compilation cache under
    tmp_path."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_attention_tools_run_on_the_cpu():
    rows = attn_microbench.run(1, ((64, 64), (4096, 64)), device="cpu",
                               fwd_steps=1, grad_steps=1, repeats=1)
    assert [(r["l"], r["lk"]) for r in rows] == [(64, 64), (4096, 2560)]
    assert all(r["fwd_body"] == "plain" and r["fwd_ms"] > 0
               and r["fwd_bwd_ms"] > 0 for r in rows)
    fwd = fwd_sweep.run(1, ("source",), shape=(256, 64), device="cpu",
                        steps=1, repeats=1)
    assert list(fwd["layer"]) == ["source"]
    assert fwd["compaction"]["full_ms"] > 0
    bwd = bwd_sweep.run(1, ("source",), shapes={"small": (256, 64)},
                        device="cpu", steps=1, repeats=1)
    assert list(bwd) == ["source"] and bwd["source"]["small"]["ms"] > 0
    res = lane_ab.run(l=32, b=1, device="cpu", iters=1)
    assert list(res) == ["QK^T  C=64", "QK^T  C=128", "PV    C=64",
                         "PV    C=128"]


def test_entry_swap_hands_the_variant_entry_and_restores(monkeypatch):
    committed = fk._entry
    monkeypatch.setattr(fk, "_entry", lambda name: f"committed {name}")
    variant = object()
    with fwd_sweep.entry_swap({"flash_bwd": variant}):
        assert fk._entry("flash_bwd") is variant
        assert fk._entry("flash_fwd_nomax_lse") == \
            "committed flash_fwd_nomax_lse"
    assert fk._entry("flash_bwd") == "committed flash_bwd"
    with pytest.raises(KeyError):
        with fwd_sweep.entry_swap({}):
            raise KeyError("restored after an exception too")
    assert fk._entry("x") == "committed x"
    # `source` is the committed library, the others are built at once
    built = []
    got = fwd_sweep.built_entries(
        ("keys64", "source", "wg3"),
        lambda names: built.append(names) or {n: {"e": n} for n in names},
        ("e",))
    assert built == [["keys64", "wg3"]]
    assert got == {"keys64": {"e": "keys64"}, "source": {"e": "committed e"},
                   "wg3": {"e": "wg3"}}
    assert list(got) == ["keys64", "source", "wg3"]
    monkeypatch.setattr(fk, "_entry", committed)
    # the default variants are the C 64 ones fwd_ab / bwd_ab can build
    from maskunet_tpu_torch.tools import bwd_ab, fwd_ab
    assert set(fwd_sweep.C64_VARIANTS) <= set(fwd_ab.NOMAX_VARIANTS)
    src = fk.SOURCES["flash_bwd"].read_text()
    assert set(bwd_sweep.VARIANTS) == set(bwd_ab.variants(src))
    assert fwd_ab.variants(fk.SOURCES["flash_fwd_nomax"].read_text(),
                           fwd_sweep.C64_VARIANTS)


ROWS = {  # bf16 row offsets against an f32 row, and the verdict
    "equal": ({}, True),
    "bf16_above": ({"pq": 0.08, "miou": 0.05, "ap": 0.1}, True),
    "pq_at_bound": ({"pq": -0.0299}, True),
    "pq_past": ({"pq": -0.031}, False),
    "miou_past": ({"miou": -0.031}, False),
    "ap_within_its_wider_bound": ({"ap": -0.039}, True),
    "ap_past": ({"ap": -0.041}, False),
}


@pytest.mark.parametrize("case", list(ROWS))
def test_bf16_gate_agrees_with_jax(monkeypatch, tmp_path, capsys, case):
    f32 = {"dtype": "float32", "train_loss": 0.5, "miou": 0.6, "pq": 0.5,
           "pq_things": 0.4, "ap": 0.3, "images_per_sec": 1.0}
    delta, want = ROWS[case]
    bf16 = {**f32, "dtype": "bfloat16",
            **{k: round(f32[k] + d, 4) for k, d in delta.items()}}
    tool = _jax_tool("bf16_validation", monkeypatch, tmp_path)
    monkeypatch.setattr(tool, "run", lambda dtype, epochs, img: (
        f32 if dtype == "float32" else bf16))
    monkeypatch.setattr(sys, "argv", ["bf16_validation.py", "1", "16"])
    tool.main()
    jax_verdict = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_verdict == f"bf16 parity: {'PASS' if want else 'FAIL'}"
    assert bf16_validation.parity_ok(f32, bf16) is want


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """A fraction sweep (0.5, 1.0) of coco_panoptic at 16 px on a fake
    COCO layout of 4 training images: (workdir, rows, records)."""
    base = tmp_path_factory.mktemp("sweep")
    root = str(base / "coco")
    tfake.make_coco(root, n=4, size=40)
    work = str(base / "work")
    get = trecipes.get
    trecipes.get = lambda n: dataclasses.replace(get(n), img_size=16)
    try:
        records = run_fraction_sweep.main([
            "--data-root", root, "--workdir", work, "--fractions", "0.5",
            "1.0", "--max-epochs", "1", "--batch-size", "2", "--lr", "1e-3",
            "--max-eval-batches", "1", "--compute-dtype", "float32",
            "--device", "cpu"])
    finally:
        trecipes.get = get
    with open(os.path.join(work, "sweep_results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return work, rows, records


def _jax_sweep_keys(monkeypatch, tmp_path) -> set:
    tool = _jax_tool("run_fraction_sweep", monkeypatch, tmp_path)

    class Result:
        best_loss, best_iou, history = 1.0, 0.5, [{}]
        stop_reason, images_per_sec, state = "completed", 1.0, None

    monkeypatch.setattr(jloop, "train", lambda *a, **k: Result())
    monkeypatch.setattr(jev, "evaluate_panoptic", lambda *a, **k: {
        "miou": 0.5, "pq": {"All": {"pq": 0.5}}, "ap": {"AP": 0.5}})
    monkeypatch.setattr(sys, "argv", [
        "run_fraction_sweep.py", "--data-root", "unused", "--workdir",
        str(tmp_path / "jax"), "--fractions", "1.0"])
    tool.main()
    with open(tmp_path / "jax" / "sweep_results.jsonl") as f:
        return set(json.loads(f.readline()))


def test_fraction_sweep_rows_have_the_jax_tools_keys(sweep, monkeypatch,
                                                     tmp_path):
    work, rows, records = sweep
    assert rows == records
    assert [r["fraction"] for r in rows] == [0.5, 1.0]
    keys = _jax_sweep_keys(monkeypatch, tmp_path)
    for r in rows:
        assert set(r) == keys
        assert r["seeds"] == 1 and r["lr_override"] == 1e-3
        assert r["max_epochs_budget"] == 1 and r["epochs_run"] == 1.0
        assert all(math.isfinite(r[k]) for k in ("val_miou", "pq", "ap"))
    assert os.path.isdir(os.path.join(work, "frac_50_s0"))


def test_plot_sweep_draws_the_file(sweep, tmp_path):
    out = str(tmp_path / "sweep.png")
    assert plot_sweep.main([os.path.join(sweep[0], "sweep_results.jsonl"),
                            out]) == out
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plateau_bands_equals_jax(monkeypatch, tmp_path, capsys):
    tool = _jax_tool("plateau_bands", monkeypatch, tmp_path)
    with open(os.path.join(REPO, "recipes_plateau.json")) as f:
        plateau = json.load(f)
    with open(os.path.join(REPO, "recipes_e2e.json")) as f:
        demo = json.load(f)
    assert plateau_bands.build_comparison(plateau, demo) == \
        tool.build_comparison(plateau, demo)
    # main on copies: both rewrite their copy the same way
    copies = {}
    for who in ("port", "jax"):
        d = tmp_path / who
        d.mkdir()
        for name in ("recipes_plateau.json", "recipes_e2e.json"):
            shutil.copy(os.path.join(REPO, name), d / name)
        copies[who] = d
    args = ["--plateau", str(copies["port"] / "recipes_plateau.json"),
            "--demo", str(copies["port"] / "recipes_e2e.json")]
    summary = plateau_bands.main(args)
    monkeypatch.setattr(sys, "argv", [
        "plateau_bands.py",
        "--plateau", str(copies["jax"] / "recipes_plateau.json"),
        "--demo", str(copies["jax"] / "recipes_e2e.json")])
    tool.main()
    capsys.readouterr()
    assert (copies["port"] / "recipes_plateau.json").read_text() == \
        (copies["jax"] / "recipes_plateau.json").read_text()
    assert summary["undocumented_misses"] == []
    dry = plateau_bands.main(args + ["--dry-run"])
    assert dry == summary


@pytest.mark.parametrize("script", ["r3_onchip_queue.sh",
                                    "tunnel_wait_and_run.sh"])
def test_queue_scripts_parse_and_name_real_modules(script):
    path = os.path.join(TOOLS, script)
    subprocess.run(["bash", "-n", path], check=True)
    with open(path) as f:
        text = f.read()
    # each script runs from its own checkout's root
    assert 'cd "$(dirname "$0")/../.." || exit 1' in text
    modules = re.findall(r"python -m (maskunet_tpu_torch[\w.]+)", text)
    for m in modules:
        assert importlib.util.find_spec(m) is not None, m
    if script == "r3_onchip_queue.sh":
        assert len(modules) == 5
    else:
        assert "maskunet_tpu_torch/tools/r3_onchip_queue.sh" in text


@pytest.mark.parametrize("tool", CARD_TOOLS)
def test_card_tools_refuse_a_host_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"maskunet_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit, match=f"{tool}: no CUDA device"):
        mod.main([])
