"""The port's command line (`maskunet_tpu_torch.cli`) against the JAX
package's, and the reference-checkpoint import behind `import-torch`.

- `recipes` prints JAX's listing byte for byte.
- Each subcommand's JSON result line has JAX's keys (and values): both
  CLIs run in-process with the library calls behind them stubbed alike
  (training, evaluation, prediction, export, the checkpoint I/O), so
  what is compared is the command line itself; those calls are held to
  JAX's by their own test files.
- The parallel flags with JAX's meanings (the CPU runs of `--n-data` and
  `--pipeline` are in tests/test_torch_parallel.py and
  tests/test_torch_pipeline.py), `--step-timeout-abort` alone returns 2
  with one error line; `--compute-dtype auto` is f32 on the CPU.
- `convert_state_dict` on a `module.`-prefixed reference state_dict
  gives the parameters and report of JAX's; `export_state_dict` JAX's
  state_dict.
- The whole CLI for real on the CPU at 16 px: train, evaluate (the three
  modes), visualize, predict, export (int8) and import-torch of a
  `module.`-prefixed .pth, whose evaluation equals the source state's.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from maskunet_tpu import cli as jcli
from maskunet_tpu import export as jexport
from maskunet_tpu.core import checkpoint as jckpt
from maskunet_tpu.tasks import evaluators as jev
from maskunet_tpu.tasks import predict as jpredict
from maskunet_tpu.train import loop as jloop
from maskunet_tpu.train import step as jstep
from maskunet_tpu.utils import torch_import as jti
from maskunet_tpu.utils import visualize as jviz
from maskunet_tpu_torch import cli as tcli
from maskunet_tpu_torch import export as texport
from maskunet_tpu_torch.core import checkpoint as tckpt
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.tasks import evaluators as tev
from maskunet_tpu_torch.tasks import predict as tpredict
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.train import step as tstep
from maskunet_tpu_torch.utils import jax_weights
from maskunet_tpu_torch.utils import torch_import as tti
from maskunet_tpu_torch.utils import visualize as tviz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while `train()` runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _json_line(out: str) -> dict:
    return json.loads([l for l in out.splitlines() if l.startswith("{")][-1])


def test_recipes_listing_equals_jax(capsys):
    assert jcli.main(["recipes"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["recipes"]) == 0
    assert capsys.readouterr().out == want and want.count("\n") == 11


# --- the command line alone, library calls stubbed ------------------------

def _stub_both(monkeypatch, tmp_path):
    """Stubs every library call the CLIs make below their argument
    handling, alike in both packages; returns the calls each received."""
    seen = {"jax": [], "port": []}
    train_result = SimpleNamespace(best_loss=1.5, best_iou=0.25,
                                   images_per_sec=7.0)
    metrics = {"ce_loss": 1.5, "loss": 1.5, "miou": 0.25}
    instances = {50: {"AP": 0.5, "AR": 0.25}, 100: {"AP": 0.5, "AR": 0.25}}
    panoptic = {"ap": {"AP": 0.5}, "pq": {"All": {"pq": 0.25}},
                "miou": 0.125}

    def export(recipe, num_classes, workdir, tag, out, **kw):
        os.makedirs(out, exist_ok=True)
        name = (jexport if "platforms" in kw and "device" not in kw
                else texport).MODULE_NAME
        with open(os.path.join(out, name), "wb") as f:
            f.write(b"x" * 123)
        return out

    for who, loop, ev, pred, ex, ckpt, ti, step, viz in (
            ("jax", jloop, jev, jpredict, jexport, jckpt, jti, jstep, jviz),
            ("port", tloop, tev, tpredict, texport, tckpt, tti, tstep,
             tviz)):
        def record(name, result, who=who):
            def fn(*args, **kw):
                seen[who].append((name, kw))
                return result(*args, **kw) if callable(result) else result
            return fn

        ts = SimpleNamespace(params={}, model_state={},
                             replace=lambda **kw: ts)
        monkeypatch.setattr(loop, "train", record("train", train_result))
        monkeypatch.setattr(loop, "evaluate", record("evaluate", metrics))
        monkeypatch.setattr(loop, "setup_state", record("setup_state", ts))
        monkeypatch.setattr(ev, "evaluate_instances",
                            record("evaluate_instances", instances))
        monkeypatch.setattr(ev, "evaluate_panoptic",
                            record("evaluate_panoptic", panoptic))
        monkeypatch.setattr(pred, "predict_directory",
                            record("predict_directory", ["a", "b", "c"]))
        monkeypatch.setattr(ex, "export_serving_artifact",
                            record("export", export))
        monkeypatch.setattr(ti, "load_torch_checkpoint",
                            record("load_torch_checkpoint", {}))
        monkeypatch.setattr(ti, "convert_state_dict", record(
            "convert_state_dict",
            ({}, {}, {"ignored": ["x.num_batches_tracked", "y"],
                      "unexpected": ["y"]})))
        pred = np.zeros((2, 16, 16), np.int32)
        if who == "port":
            pred = torch.from_numpy(pred)
        monkeypatch.setattr(step, "make_eval_step", record(
            "make_eval_step", lambda *a, pred=pred, **k: lambda ts, batch: {
                "pred": pred}))
        monkeypatch.setattr(viz, "save_sample", record("save_sample", None))
        monkeypatch.setattr(viz, "save_prediction",
                            record("save_prediction", None))
    # JAX's visualize jits the eval step: the stub state is no pytree
    monkeypatch.setattr(jax, "jit", lambda fn: fn)
    # the checkpoint I/O: JAX's manager, the port's functions
    path = str(tmp_path / "ckpt.msgpack")
    monkeypatch.setattr(jckpt.CheckpointManager, "restore_for_inference",
                        lambda self, ts, tag="best": ts)
    monkeypatch.setattr(jckpt.CheckpointManager, "has",
                        lambda self, tag="latest": True)
    monkeypatch.setattr(jckpt.CheckpointManager, "save_best",
                        lambda self, ts: path)
    monkeypatch.setattr(jckpt.CheckpointManager, "save_latest",
                        lambda self, ts: path)
    monkeypatch.setattr(tckpt, "restore_inference", lambda p, ts: ts)
    monkeypatch.setattr(tckpt.CheckpointManager, "save_best",
                        lambda self, ts: path)
    monkeypatch.setattr(tckpt.CheckpointManager, "save_latest",
                        lambda self, ts: path)
    return seen


SUBCOMMANDS = {
    "train": ["train", "--max-steps", "2"],
    "evaluate": ["evaluate", "--max-batches", "1"],
    "evaluate_instances": ["evaluate", "--mode", "instances",
                           "--max-queries", "50", "100", "--split", "train"],
    "evaluate_panoptic": ["evaluate", "--mode", "panoptic", "--export-dir",
                          "EXPORT"],
    "visualize": ["visualize", "--out", "VIZ"],
    "predict": ["predict", "--images", "IMAGES", "--out", "PRED",
                "--num-classes", "8", "--instances"],
    "export": ["export", "--out", "ART", "--num-classes", "8",
               "--quantize", "int8"],
    "import-torch": ["import-torch", "--torch-checkpoint", "REF.pth",
                     "--num-classes", "8"],
}


@pytest.mark.parametrize("name", list(SUBCOMMANDS))
def test_json_lines_equal_jax(name, monkeypatch, tmp_path, capsys):
    seen = _stub_both(monkeypatch, tmp_path)
    argv = [str(tmp_path / a) if a.isupper() or a.endswith(".pth") else a
            for a in SUBCOMMANDS[name]]
    common = ["--recipe", "synthetic_semantic", "--workdir",
              str(tmp_path / "work"), "--platform", "cpu"]
    assert jcli.main(argv + common) == 0
    want = _json_line(capsys.readouterr().out)
    assert tcli.main(argv + common) == 0
    got = _json_line(capsys.readouterr().out)
    assert got == want
    # the library calls received the same keyword arguments, but for the
    # port's device and JAX's mesh
    strip = {"device", "mesh", "pipeline_microbatches"}
    assert [(n, set(kw) - strip) for n, kw in seen["port"]
            if n != "setup_state"] == [(n, set(kw) - strip)
                                       for n, kw in seen["jax"]
                                       if n != "setup_state"]
    calls = dict(seen["port"])
    if name == "evaluate_instances":
        assert calls["evaluate_instances"]["split"] == "train"
        assert calls["evaluate_instances"]["max_queries"] == (50, 100)
    if name in calls:
        assert calls[name].get("device", "cpu") == "cpu"


@pytest.mark.parametrize("flags", [
    ["--n-data", "2"], ["--pipeline", "2"], ["--distributed"],
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "0"]])
def test_parallel_flags_are_refused(flags, monkeypatch, capsys):
    """The parallel flags with JAX's meanings. On a host without the cards
    they need, `--n-data 2` and `--pipeline 2` on the card default exit 2
    with one error line naming the device count, before any training (a
    one-card host, as the card's machine);
    `--distributed` joins the launcher's process group (here one process,
    from MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK) and trains on its mesh;
    `--coordinator`, `--num-processes` and `--process-id` without
    `--distributed` change nothing, as in JAX's CLI."""
    import socket

    import torch.distributed as dist
    calls = []

    def train(recipe, data_root, workdir, **kw):
        mesh = kw["mesh"]   # its rank and device, read while the group is up
        calls.append({**kw, "rank_device": None if mesh is None else
                      (mesh.rank, mesh.device)})
        return SimpleNamespace(best_loss=0.0, best_iou=0.0,
                               images_per_sec=0.0)

    monkeypatch.setattr(tloop, "train", train)
    if flags[0] in ("--n-data", "--pipeline"):
        # as on the card's machine: one card
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert tcli.main(["train", "--recipe", "ade_semantic", *flags]) == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith(f"error: {flags[0]} 2")
        assert err[0].endswith(("this host has 1", "got 1")) and not calls
        return
    if flags[0] == "--distributed":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", port),
                     ("WORLD_SIZE", 1), ("RANK", 0)):
            monkeypatch.setenv(k, str(v))
        flags = [*flags, "--platform", "cpu"]
    assert tcli.main(["train", "--recipe", "ade_semantic", *flags]) == 0
    mesh = calls[0]["mesh"]
    if flags[0] == "--distributed":
        assert mesh.shape == {"data": 1, "model": 1}
        assert calls[0]["rank_device"] == (0, torch.device("cpu"))
        assert not dist.is_initialized()
    else:
        assert mesh is None


def test_refusals_as_jax(monkeypatch, capsys):
    monkeypatch.setattr(tloop, "train", lambda *a, **k: None)
    for main in (jcli.main, tcli.main):
        assert main(["train", "--recipe", "ade_semantic",
                     "--step-timeout-abort"]) == 2
        assert main(["train", "--recipe", "nope"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[2] and "--step-timeout-abort requires" in err[0]
    assert err[1] == err[3] and "unknown recipe 'nope'" in err[1]


def test_compute_dtype_auto_is_f32_on_the_cpu(monkeypatch):
    seen = {}

    def train(recipe, data_root, workdir, **kw):
        seen.update(kw)
        return SimpleNamespace(best_loss=0.0, best_iou=0.0,
                               images_per_sec=0.0)

    monkeypatch.setattr(tloop, "train", train)
    assert tcli.main(["train", "--recipe", "ade_semantic", "--platform",
                      "cpu"]) == 0
    assert seen["compute_dtype"] == "float32" and seen["device"] == "cpu"
    assert tcli.main(["train", "--recipe", "ade_semantic"]) == 0
    assert seen["compute_dtype"] == "bfloat16" and seen["device"] == "cuda"


# --- the reference-checkpoint import --------------------------------------

def _reference_state_dict(cfg):
    params, state = tmu.init(torch.Generator().manual_seed(3), cfg)
    sd = tti.export_state_dict(params, state)
    sd = {f"module.{k}": v for k, v in sd.items()}
    sd["module.downsample1.emb_layer.1.weight"] = torch.zeros(4)
    sd["module.stray.weight"] = torch.ones(2)
    return sd


def test_convert_state_dict_equals_jax():
    cfg = tmu.MaskAttnUNetConfig(c_out=8, img_size=16)
    sd = _reference_state_dict(cfg)
    tpl_params, tpl_state = tmu.init(torch.Generator().manual_seed(0), cfg)
    params, state, report = tti.convert_state_dict(sd, tpl_params,
                                                   tpl_state)
    jtpl = jax_weights.to_jax(tpl_params, tpl_state, cfg)
    jparams, jstate, jreport = jti.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, *jtpl)
    assert report == jreport
    assert report["unexpected"] == ["stray.weight"]
    want_params, want_state = jax_weights.from_jax(jparams, jstate, cfg)
    assert list(params) == list(tpl_params)
    for got, want in ((params, want_params), (state, want_state)):
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
    # and back: the reference state_dict of either package
    jsd = jti.export_state_dict(jparams, jstate)
    tsd = tti.export_state_dict(params, state)
    assert list(tsd) == list(jsd)
    for k in tsd:
        np.testing.assert_array_equal(tsd[k].numpy(), jsd[k])
    with pytest.raises(KeyError, match="missing 'norm.weight'"):
        tti.convert_state_dict({k: v for k, v in sd.items()
                                if k != "module.norm.weight"},
                               tpl_params, tpl_state)
    bad = {**sd, "module.final_layer.0.weight": torch.zeros(9, 64, 1, 1)}
    with pytest.raises(ValueError, match="shape mismatch"):
        tti.convert_state_dict(bad, tpl_params, tpl_state)


def test_load_torch_checkpoint(tmp_path):
    sd = {"module.a": torch.ones(2)}
    torch.save(sd, tmp_path / "ok.pth")
    got = tti.load_torch_checkpoint(str(tmp_path / "ok.pth"))
    assert list(got) == ["module.a"] and torch.equal(got["module.a"],
                                                     sd["module.a"])
    torch.save([torch.ones(2)], tmp_path / "list.pth")
    with pytest.raises(ValueError, match="expected a bare state_dict"):
        tti.load_torch_checkpoint(str(tmp_path / "list.pth"))


# --- the whole command line, for real, on the CPU -------------------------

def test_cli_end_to_end_on_the_cpu(monkeypatch, tmp_path, capsys):
    """A 16 px synthetic recipe, batch 2: every subcommand on the CPU, the
    imported reference checkpoint evaluating as its source state does."""
    import cv2
    tiny = dataclasses.replace(trecipes.get("synthetic_panoptic"),
                               name="tiny", img_size=16, batch_size=2,
                               eval_max_queries=(10, 20))
    monkeypatch.setitem(trecipes.RECIPES, "tiny", tiny)
    work = str(tmp_path / "work")
    common = ["--recipe", "tiny", "--platform", "cpu"]

    def run(*argv) -> dict:
        assert tcli.main([*argv, *common]) == 0
        return _json_line(capsys.readouterr().out)

    out = run("train", "--workdir", work, "--max-steps", "2",
              "--log-every", "0")
    assert set(out) == {"recipe", "best_loss", "best_iou",
                        "images_per_sec"} and out["recipe"] == "tiny"
    evals = [["--mode", "semantic", "--max-batches", "1"],
             ["--mode", "instances", "--max-batches", "1",
              "--split", "train"],
             ["--mode", "panoptic", "--max-batches", "1", "--export-dir",
              str(tmp_path / "pan")]]
    source = [run("evaluate", "--workdir", work, "--tag", "latest",
                  "--attn-output-layout", "literal_view", *e)
              for e in evals]
    assert {"loss", "miou"} <= set(source[0])
    assert set(source[1]["instances"]) == {"10", "20"}
    assert {"ap", "pq", "miou"} <= set(source[2])
    assert os.path.exists(tmp_path / "pan" / "predictions.json")

    out = run("visualize", "--workdir", work, "--tag", "latest", "--out",
              str(tmp_path / "viz"))
    assert all(os.path.getsize(p) > 0 for p in out["saved"])

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(images / f"{i}.png"),
                    rng.integers(0, 256, (20, 24, 3)).astype(np.uint8))
    out = run("predict", "--workdir", work, "--tag", "latest", "--images",
              str(images), "--out", str(tmp_path / "pred"),
              "--num-classes", "8")
    assert out == {"written": 3, "out": str(tmp_path / "pred")}

    out = run("export", "--workdir", work, "--tag", "latest", "--out",
              str(tmp_path / "art"), "--num-classes", "8", "--quantize",
              "int8", "--calibrate-images", str(images))
    assert out["bytes"] == os.path.getsize(tmp_path / "art" / "model.pt2")
    runner, meta = texport.load_serving_artifact(str(tmp_path / "art"))
    assert meta["quantize"] == "int8" and meta["calibrated"]
    assert runner(np.zeros((2, 16, 16, 3), np.uint8)).shape == (2, 16, 16)

    # the trained state as a reference .pth, DataParallel-prefixed
    ts = tckpt.restore_inference(
        os.path.join(work, "checkpoint_synth_pan_latest.msgpack"),
        tloop.setup_state(tiny, tloop.model_config(tiny, 8),
                          tloop.make_optimizer(tiny), device="cpu"))
    sd = tti.export_state_dict(ts.params, ts.model_state)
    torch.save({f"module.{k}": v for k, v in sd.items()},
               tmp_path / "ref.pth")
    imported = str(tmp_path / "imported")
    out = run("import-torch", "--workdir", imported, "--torch-checkpoint",
              str(tmp_path / "ref.pth"), "--num-classes", "8")
    assert out["attn_output_layout"] == "literal_view"
    assert out["ignored_keys"] == sum(k.endswith("num_batches_tracked")
                                      for k in sd)
    assert sorted(os.listdir(imported)) == [
        "checkpoint_synth_pan_best.msgpack",
        "checkpoint_synth_pan_import_meta.json",
        "checkpoint_synth_pan_latest.msgpack"]
    # 'auto' reads the sidecar's literal_view, as the source was run with
    got = [run("evaluate", "--workdir", imported, *e) for e in evals[:2]]
    assert got == source[:2]
