"""The port's training loop (maskunet_tpu_torch.train.loop) on the CPU.

- The three lr schedules give optax's lr (as the JAX `make_optimizer`
  builds it) at every update of a 50-update run, within 1e-6 relative
  plus 1e-7 of the peak lr: optax evaluates them in f32 (the port in
  f64), so where the cosine nears 0, 1 + cos(pi n / T) cancels to an
  error of about one f32 step of the peak.
- `EarlyStopping` and `OverfitGuard` make the JAX copies' decisions.
- `train()` of synthetic_semantic at 16 px (a quarter of the 64 examples:
  two steps an epoch at batch 8) writes best and latest checkpoints,
  resumes at the saved step with the saved state bit for bit and ends
  where an uninterrupted run ends, bit for bit; gives each `stop_reason`;
  keeps the best state; warm-starts; raises on a NaN under `debug_nan`.
- `evaluate()` (lagged metrics over `pad_last` batches, padded rows
  masked by `valid`) gives JAX's `evaluate` on the same weights: the loss
  within 1e-4 relative (f32 logits, test_torch_model.py's bound), mIoU
  within 1e-3 (a near-tie may flip a pixel's class).

Each full-width state is ~270 MB on disk; tests delete their files.
"""

import dataclasses
import json
import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

from maskunet_tpu.core import loop_control as jcontrol
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu.train import loop as jloop
from maskunet_tpu_torch.core import checkpoint as tckpt
from maskunet_tpu_torch.core import loop_control as tcontrol
from maskunet_tpu_torch.core import metrics_log
from maskunet_tpu_torch.parallel import mesh as mesh_lib
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.utils import jax_weights, profiling

SMALL = dict(img_size=16)
TR = dataclasses.replace(trecipes.get("synthetic_semantic"), **SMALL)
QUARTER = dict(data_fraction=0.25, device="cpu", verbose=False)


def _remove(directory) -> None:
    for name in os.listdir(directory):
        if ".msgpack" in name:
            os.remove(os.path.join(directory, name))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host, and torch's default of a thread per core in each
    oversubscribes it (a 16 px `train()` then runs ~10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def workdir(tmp_path):
    yield str(tmp_path)
    _remove(tmp_path)


# ---------------------------------------------------------------------------
# schedules and loop control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "warmup_cosine", "step"])
def test_schedule_gives_optax_lr_at_every_update(schedule):
    """JAX's lr at update n read off its optimizer: with p = 1 and a zero
    gradient an adamw update is -lr(n) * weight_decay."""
    jr = jrecipes.get("synthetic_semantic")
    tx = jloop.make_optimizer(jr, lr_schedule=schedule, total_steps=50,
                              warmup_steps=5)
    p = {"w": np.ones(1, np.float32)}
    state = tx.init(p)
    want = []
    for _ in range(50):
        upd, state = tx.update({"w": np.zeros(1, np.float32)}, state, p)
        want.append(-float(upd["w"][0]) / jr.weight_decay)
    spec = tloop.make_optimizer(TR, lr_schedule=schedule, total_steps=50,
                                warmup_steps=5)
    w = torch.ones(1, requires_grad=True)
    opt = spec([w])
    sched = spec.scheduler(opt)
    got = []
    for _ in range(50):
        got.append(opt.param_groups[0]["lr"])
        w.grad = torch.zeros(1)
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * TR.lr)
    if schedule == "warmup_cosine":
        assert got[0] == 0.0       # optax reads its count before the update


@pytest.mark.parametrize("patience", [0, 2, 4])
def test_early_stopping_and_guard_decide_as_jax(patience):
    losses = np.random.default_rng(patience).random(40).round(2)
    calls = {"t": 0, "j": 0}
    t = tcontrol.EarlyStopping(patience, on_improve=lambda: calls.__setitem__(
        "t", calls["t"] + 1))
    j = jcontrol.EarlyStopping(patience, on_improve=lambda: calls.__setitem__(
        "j", calls["j"] + 1))
    assert [t(x) for x in losses] == [j(x) for x in losses]
    assert calls["t"] == calls["j"] > 0
    tg, jg = tcontrol.OverfitGuard(0.1), jcontrol.OverfitGuard(0.1)
    ious = np.random.default_rng(patience + 10).random(40) * 0.3
    assert [tg(x) for x in ious] == [jg(x) for x in ious]


def test_watchdog_fires_under_a_stall_and_not_while_paused():
    stalls = []
    with profiling.StallWatchdog(0.2, poll_s=0.02,
                                 on_stall=lambda s, c: stalls.append(c)) \
            as dog:
        dog.beat("step 1")
        deadline = time.monotonic() + 10
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.02)
        assert stalls and stalls[0] == "step 1"
        dog.pause("epoch end")
        n = len(stalls)
        time.sleep(0.5)
        assert len(stalls) == n
    assert not dog._thread.is_alive()


def test_nan_guard_names_the_entry_and_logger_writes(tmp_path):
    profiling.nan_guard({"loss": torch.tensor(1.0)}, "step 0")
    with pytest.raises(profiling.NonFiniteError, match="miou at step 3"):
        profiling.nan_guard({"loss": torch.tensor(1.0),
                             "miou": torch.tensor(float("nan"))}, "step 3")
    log = metrics_log.MetricsLogger(str(tmp_path), "t")
    log.log({"epoch": 1, "loss": torch.tensor(0.5)})
    log.close()
    rec = json.loads((tmp_path / "t_log.jsonl").read_text())
    assert rec["loss"] == 0.5 and "wall_s" in rec


# ---------------------------------------------------------------------------
# train() and evaluate()
# ---------------------------------------------------------------------------

def _states_equal(a, b) -> None:
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k].detach(), b.params[k].detach()), k
        sa = a.optimizer.state[a.params[k]]
        sb = b.optimizer.state[b.params[k]]
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[m], sb[m]), (k, m)
        assert float(sa["step"]) == float(sb["step"])
    for k in a.model_state:
        assert torch.equal(a.model_state[k], b.model_state[k]), k
    for ma, mb in zip(a.masks, b.masks):
        assert torch.equal(ma, mb)


def _template():
    cfg = tloop.model_config(TR, 8)
    return tloop.setup_state(TR, cfg, tloop.make_optimizer(TR), device="cpu")


def test_train_checkpoints_and_resume_as_an_uninterrupted_run(tmp_path):
    run, whole = str(tmp_path / "run"), str(tmp_path / "whole")
    try:
        first = tloop.train(TR, None, run, max_epochs=2, eval_every=1,
                            eval_max_batches=1, ckpt_every=1, **QUARTER)
        assert first.stop_reason == "completed"
        assert [r["step"] for r in first.history] == [2, 4]
        for r in first.history:
            assert np.isfinite([r["loss"], r["miou"], r["val_loss"],
                                r["val_miou"]]).all()
            assert r["val_sample_images"] == 8
        for tag in ("best", "latest"):
            assert os.path.exists(os.path.join(
                run, f"{TR.checkpoint_name}_{tag}.msgpack"))
        lines = open(os.path.join(run, "train_synthetic_semantic_log.jsonl")
                     ).read().splitlines()
        assert [json.loads(x)["epoch"] for x in lines] == [1, 2]
        # the latest checkpoint is the returned state, bit for bit,
        # dropout generator included
        saved = tckpt.restore(os.path.join(
            run, f"{TR.checkpoint_name}_latest.msgpack"), _template())
        _states_equal(saved, first.state)
        assert torch.equal(saved.generator.get_state(),
                           first.state.generator.get_state())
        # resume: the third epoch only, from step 4, as a 3-epoch run does
        resumed = tloop.train(TR, None, run, max_epochs=3, resume=True,
                              **QUARTER)
        assert [r["step"] for r in resumed.history] == [6]
        assert resumed.state.step == 6
        uninterrupted = tloop.train(TR, None, whole, max_epochs=3,
                                    save_checkpoints=False, **QUARTER)
        assert [r["step"] for r in uninterrupted.history] == [2, 4, 6]
        _states_equal(resumed.state, uninterrupted.state)
        assert resumed.history[0]["loss"] == uninterrupted.history[2]["loss"]
    finally:
        _remove(run)


@pytest.mark.parametrize("reason, recipe_kw, train_kw, epochs", [
    ("completed", {}, {}, 3),
    ("max_steps", {}, {"max_steps": 3}, 2),
    ("overfit_guard", {"overfit_margin": -1.0}, {}, 1),
    ("early_stop", {"patience": 0, "lr": 50.0}, {}, 2),
])
def test_train_stop_reasons(workdir, reason, recipe_kw, train_kw, epochs):
    recipe = dataclasses.replace(TR, **recipe_kw)
    res = tloop.train(recipe, None, workdir, max_epochs=3,
                      save_checkpoints=False, **train_kw, **QUARTER)
    assert res.stop_reason == reason
    assert len(res.history) == epochs
    assert not any(".msgpack" in n for n in os.listdir(workdir))


def test_keep_best_state(workdir):
    res = tloop.train(TR, None, workdir, max_epochs=2, save_checkpoints=False,
                      keep_best_state=True, **QUARTER)
    losses = [r["loss"] for r in res.history]
    best = res.best_state
    assert best is not None and best.optimizer is res.state.optimizer
    for k, p in best.params.items():
        assert p.data_ptr() != res.state.params[k].data_ptr()
    same = all(torch.equal(p, res.state.params[k].detach())
               for k, p in best.params.items())
    # EarlyStopping improves on loss <= best: the last epoch is the best
    # one exactly when its loss is no higher than the first's
    assert same == (losses[1] <= losses[0])


def test_debug_nan_raises_on_injected_nan(workdir, monkeypatch):
    make = tloop.step_lib.make_train_step

    def poisoned(*args, **kw):
        step = make(*args, **kw)

        def run(ts, batch):
            ts, metrics = step(ts, batch)
            if ts.step == 2:
                metrics["loss"] = metrics["loss"] * float("nan")
            return ts, metrics
        return run

    monkeypatch.setattr(tloop.step_lib, "make_train_step", poisoned)
    with pytest.raises(profiling.NonFiniteError, match="loss at step 1"):
        tloop.train(TR, None, workdir, max_epochs=1, debug_nan=True,
                    save_checkpoints=False, **QUARTER)


def test_warm_start_from_a_checkpoint_keeps_the_new_head(workdir):
    donor = _template()
    with torch.no_grad():
        for p in donor.params.values():
            p.add_(0.5)
    tckpt.save(os.path.join(workdir, "donor.msgpack"), donor)
    recipe = dataclasses.replace(TR, num_classes=6)
    res = tloop.train(recipe, None, workdir, max_epochs=0,
                      save_checkpoints=False, init_drop=("attn1",),
                      init_from=os.path.join(workdir, "donor.msgpack"),
                      **QUARTER)
    fresh = tloop.setup_state(recipe, tloop.model_config(recipe, 6),
                              tloop.make_optimizer(recipe), device="cpu")
    for k, p in res.state.params.items():
        kept = k.startswith(("final_layer.", "self_attention1."))
        want = fresh.params[k] if kept else donor.params[k]
        assert torch.equal(p.detach(), want.detach()), k


@pytest.mark.parametrize("kw, error, match", [
    # the parallel slices are ported: what stays refused is JAX's
    # refusal of a pipeline on a mesh without the 'pipe' axis, a (data,
    # model) mesh or a data mesh
    pytest.param({"pipeline_microbatches": 2,
                  "mesh": mesh_lib.Mesh((torch.device("cpu"),) * 2,
                                        n_model=2)},
                 ValueError, "a 'pipe' axis", id="kw0-parallel slice"),
    pytest.param({"pipeline_microbatches": 2,
                  "mesh": mesh_lib.Mesh((torch.device("cpu"),))},
                 ValueError, "a 'pipe' axis", id="kw1-parallel slice"),
    # the data slice is ported: a real dataset now needs its data_root
    pytest.param({"recipe": "ade_semantic"}, ValueError, "data_root",
                 id="kw2-data slice"),
])
def test_unported_options_raise(workdir, kw, error, match):
    recipe = dataclasses.replace(trecipes.get(kw.pop("recipe",
                                                     "synthetic_semantic")),
                                 **SMALL)
    with pytest.raises(error, match=match):
        tloop.train(recipe, None, workdir, max_epochs=1, **kw, **QUARTER)


def test_train_defaults_to_cuda_and_raises_without(workdir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.train(TR, None, workdir, max_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.evaluate(TR, None, _template())


def test_train_profile_watchdog_and_grad_accum(workdir):
    trace_dir = os.path.join(workdir, "trace")
    res = tloop.train(TR, None, workdir, max_epochs=2, grad_accum=2,
                      data_fraction=0.5, device="cpu", verbose=False,
                      save_checkpoints=False, step_timeout=600,
                      profile_dir=trace_dir, profile_steps=1,
                      lr_schedule="cosine", log_every=1)
    # 32 examples, 16 a step: two steps an epoch; the trace of step 3
    assert [r["step"] for r in res.history] == [2, 4]
    assert res.state.scheduler.last_epoch == 4
    assert os.path.exists(os.path.join(trace_dir, "trace.json"))


def test_evaluate_matches_jax_with_padded_batches():
    """Batch 6 over the 16 validation examples: the third batch has 4
    valid rows and 2 padded ones."""
    jr = dataclasses.replace(jrecipes.get("synthetic_semantic"), img_size=16,
                             batch_size=6)
    tr = dataclasses.replace(TR, batch_size=6)
    jcfg = jloop.model_config(jr, 8, attn_impl="dense")
    jts = jloop.setup_state(jr, jcfg, optax.adamw(jr.lr))
    want = jloop.evaluate(jr, None, jts, attn_impl="dense")
    tcfg = tloop.model_config(tr, 8)
    ts = tloop.setup_state(tr, tcfg, tloop.make_optimizer(tr), device="cpu")
    params, mstate = jax_weights.from_jax(
        jax.tree.map(np.asarray, jts.params),
        jax.tree.map(np.asarray, jts.model_state), tcfg)
    with torch.no_grad():
        for k, p in ts.params.items():
            p.copy_(params[k])
    ts.model_state = mstate
    ts.masks = tuple(torch.from_numpy(np.array(m)) for m in jts.masks)
    got = tloop.evaluate(tr, None, ts, device="cpu")
    assert set(got) == set(want) == {"ce_loss", "loss", "miou"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["miou"], want["miou"], atol=1e-3)
