"""The port's 2-stage GPipe (`maskunet_tpu_torch.parallel.pipeline`) on the
CPU, against the sequential per-microbatch loop, and against JAX.

JAX's contract (tests/test_pipeline.py): the pipelined forward, BN state
and gradients equal the sequential loop over the microbatches (eval
forward within 1e-5; train forward and state within 1e-4; gradients within
1e-4 of their scale). The port's stages share the CPU here (an explicit
device list naming it twice), the decoder on a worker thread: the same
executor the card runs on two streams. Held here at JAX's tolerances:

- the eval and train forwards, the running stats and every gradient
  against the sequential loop (the dropout keep masks drawn in the same
  order), for 2 and 4 microbatches;
- the pipelined train step against a hand-written sequential step, alone
  and composed with grad_accum as an outer loop;
- JAX's refusals (mesh sizes, a mesh without the pipe axis, both meshes,
  one microbatch, an uneven split, a missing dropout generator);
- `train(pipeline_microbatches=2)` and `cli train --pipeline 2` on the
  CPU; `--pipeline 2` on a host without two cards exits 2;
- the pipelined eval forward against JAX's `mu.apply` run per microbatch
  on the same weights (dense, 16 px, f32: 1e-4, the bound of
  tests/test_torch_model.py). No JAX pipeline or mesh is compiled here.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu_torch import cli as tcli
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.parallel import mesh as mesh_lib
from maskunet_tpu_torch.parallel import pipeline as pp
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.train import step as tstep
from maskunet_tpu_torch.utils import jax_weights

MESH = pp.make_pipe_mesh(devices=["cpu", "cpu"])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(n_micro, embed_dim=0):
    cfg = tmu.MaskAttnUNetConfig(c_out=5, img_size=16, embed_dim=embed_dim)
    g = torch.Generator().manual_seed(0)
    params, state = tmu.init(g, cfg)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    x = torch.randn(2 * n_micro, 16, 16, 3, generator=g)
    masks = tmu.make_attention_masks(g, 2, 16)
    return cfg, params, state, x, masks


def _sequential(params, state, x, masks, cfg, n_micro, train, gen=None):
    """The reference: `apply` on each microbatch in order, the running
    stats threaded through, the keep masks drawn as the forward draws."""
    outs = []
    for m in x.reshape(n_micro, -1, *x.shape[1:]):
        out, new = tmu.apply(params, state, m, cfg=cfg, masks=masks,
                             train=train, dropout_generator=gen)
        if train:
            state = {**state, **new}
        outs.append(out)
    return tmu.ModelOutput(*(None if o0 is None else
                             torch.stack([o[i] for o in outs])
                             for i, o0 in enumerate(outs[0]))), state


def test_eval_forward_matches_sequential():
    cfg, params, state, x, masks = _setup(2)
    with torch.no_grad():
        out, _ = pp.pipeline_apply(params, state,
                                   pp.split_microbatches(x, 2), cfg=cfg,
                                   mesh=MESH, masks=masks)
        ref, _ = _sequential(params, state, x, masks, cfg, 2, False)
    assert float((out.semantic - ref.semantic).abs().max()) < 1e-5


@pytest.mark.parametrize("n_micro", [2, 4])
def test_train_forward_state_and_gradients_match_sequential(n_micro):
    cfg, params, state, x, masks = _setup(n_micro, embed_dim=4)
    outs = []
    for run in ("pipeline", "sequential"):
        gen = torch.Generator().manual_seed(7)
        if run == "pipeline":
            out, new = pp.pipeline_apply(
                params, state, pp.split_microbatches(x, n_micro), cfg=cfg,
                mesh=MESH, masks=masks, train=True, dropout_generator=gen)
        else:
            out, new = _sequential(params, state, x, masks, cfg, n_micro,
                                   True, gen)
        loss = out.semantic.float().square().mean() + \
            out.embeddings.float().abs().mean()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        outs.append((out, new, grads, gen.get_state()))
    (o1, s1, g1, r1), (o2, s2, g2, r2) = outs
    assert float((o1.semantic - o2.semantic).detach().abs().max()) < 1e-4
    assert set(s1) == set(s2) == set(state)
    for k in state:
        assert float((s1[k] - s2[k]).abs().max()) < 1e-4, k
    for a, b in zip(g1, g2):
        assert (a is None) == (b is None)
        if a is not None:
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-4 * max(scale, 1.0)
    assert torch.equal(r1, r2)    # the same draws


def _sequential_step(ts, batch, cfg, task, n_micro, grad_accum):
    """One SGD update by hand: per accumulation chunk, the sequential
    forward of its microbatches and ONE loss over their outputs; the
    chunks' gradients averaged."""
    chunk = batch["image"].shape[0] // grad_accum
    grads, state = None, ts.model_state
    for i in range(grad_accum):
        rows = slice(i * chunk, (i + 1) * chunk)
        x = torch.from_numpy(batch["image"][rows])
        out, state = _sequential(ts.params, state, x, ts.masks, cfg,
                                 n_micro, True, ts.generator)
        semantic = out.semantic.reshape(-1, *out.semantic.shape[2:])
        mb = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        loss, _ = tstep._compute_loss(tmu.ModelOutput(semantic), mb, task,
                                      ts.generator)
        g = torch.autograd.grad(loss, list(ts.params.values()),
                                allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(ts.params.values(), g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    with torch.no_grad():
        for p, g in zip(ts.params.values(), grads):
            p -= 0.1 * g / grad_accum
    return ts, state


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_pipelined_step_matches_sequential_update(grad_accum):
    """`make_train_step(pipe_mesh=..., pipe_microbatches=2)` (and with
    grad_accum as the outer loop) against the update by hand."""
    results = []
    for pipelined in (True, False):
        cfg, task, ts, batch, _, _ = ranks.scenario("cached")
        ts.masks = tuple(m[:ranks.B // (2 * grad_accum)] for m in ts.masks)
        if pipelined:
            step = tstep.make_train_step(
                cfg, task, grad_accum=grad_accum,
                mask_plans=tmu.precompute_mask_plans(ts.masks),
                device="cpu", pipe_mesh=MESH, pipe_microbatches=2)
            ts, _ = step(ts, batch)
            state = ts.model_state
        else:
            ts, state = _sequential_step(ts, batch, cfg, task, 2,
                                         grad_accum)
        results.append((ts.params, state))
    (p1, s1), (p2, s2) = results
    for k in p1:
        assert float((p1[k] - p2[k]).detach().abs().max()) <= 1e-5, k
    for k in s1:
        assert float((s1[k] - s2[k]).abs().max()) <= 1e-5, k


def test_refusals_as_jax():
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs exactly 2 devices"):
            pp.make_pipe_mesh()
    with pytest.raises(ValueError, match="needs exactly 2 devices, got 1"):
        pp.make_pipe_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match=r"dp x pp mesh 2x2 != 3 devices"):
        pp.make_dp_pipe_mesh(2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="one process per rank"):
        pp.make_dp_pipe_mesh(2, devices=["cpu"] * 4)
    dp_pp = pp.make_dp_pipe_mesh(1, devices=["cpu"] * 2)
    assert dp_pp.shape == {"data": 1, "pipe": 2}
    assert dp_pp.axis_names == ("data", "pipe")
    assert MESH.shape == {"pipe": 2} and MESH.axis_names == ("pipe",)
    with pytest.raises(ValueError, match="a 'pipe' axis of size 2"):
        pp.validate_pipe_mesh(mesh_lib.make_mesh(1, devices=["cpu"]))
    cfg = tmu.MaskAttnUNetConfig(c_out=5, img_size=16)
    task = tstep.TaskConfig()
    with pytest.raises(ValueError, match="not both"):
        tstep.make_train_step(cfg, task, device="cpu", pipe_mesh=MESH,
                              pipe_microbatches=2,
                              mesh=mesh_lib.make_mesh(1, devices=["cpu"]))
    with pytest.raises(ValueError, match="must be >= 2"):
        tstep.make_train_step(cfg, task, device="cpu", pipe_mesh=MESH)
    with pytest.raises(ValueError, match="not divisible by n_micro=2"):
        pp.split_microbatches(torch.zeros(3, 2), 2)
    _, params, state, x, masks = _setup(2)
    with pytest.raises(ValueError, match="dropout_generator required"):
        pp.pipeline_apply(params, state, pp.split_microbatches(x, 2),
                          cfg=cfg, mesh=MESH, train=True)


def test_stage_keys_split_the_model():
    cfg = tmu.MaskAttnUNetConfig(c_out=5, img_size=16, embed_dim=4,
                                 with_boundary_head=True)
    params, state = tmu.init(torch.Generator().manual_seed(0), cfg)
    enc = {k for k in {**params, **state} if pp.stage_of(k) == 0}
    assert enc and all(k.startswith(("initial_conv", "downsample", "bottom",
                                     "self_attention1.", "self_attention2.",
                                     "self_attention3.")) for k in enc)
    assert any(k.startswith("self_attention4.") for k in params
               if pp.stage_of(k) == 1)


def test_pipelined_eval_forward_equals_jax():
    """The port's pipelined eval forward against JAX's forward run on each
    microbatch, on the same weights and masks."""
    cfg, params, state, x, masks = _setup(2)
    with torch.no_grad():
        out, _ = pp.pipeline_apply(params, state,
                                   pp.split_microbatches(x, 2), cfg=cfg,
                                   mesh=MESH, masks=masks)
    jcfg = jmu.MaskAttnUNetConfig(c_out=5, img_size=16, attn_impl="dense")
    jparams, jstate = jax_weights.to_jax(params, state, cfg)
    fwd = jax.jit(lambda p, s, xx: jmu.apply(
        p, s, xx, cfg=jcfg, train=False,
        masks=tuple(jnp.asarray(m.numpy()) for m in masks))[0].semantic)
    for i, m in enumerate(x.numpy().reshape(2, 2, 16, 16, 3)):
        np.testing.assert_allclose(out.semantic[i].numpy(),
                                   np.asarray(fwd(jparams, jstate, m)),
                                   atol=1e-4, rtol=1e-4)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    recipe = dataclasses.replace(trecipes.get("synthetic_semantic"),
                                 name="tiny", img_size=16, batch_size=2,
                                 num_classes=5)
    monkeypatch.setitem(trecipes.RECIPES, "tiny", recipe)
    yield recipe
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_train_loop_pipelined(tiny, tmp_path):
    res = tloop.train(tiny, None, str(tmp_path), max_steps=2,
                      pipeline_microbatches=2, device="cpu", verbose=False,
                      mesh=MESH)
    assert res.state.step == 2 and res.stop_reason == "max_steps"
    assert np.isfinite(res.history[-1]["loss"])
    assert os.path.exists(tmp_path / f"{tiny.checkpoint_name}_latest.msgpack")


def test_cli_pipeline(tiny, tmp_path, capsys):
    """`train --pipeline 2 --platform cpu` trains (both stages on the CPU,
    4 images a step); on the card default a host without two cards exits
    2 with one line naming its device count, as JAX's mesh refuses."""
    assert tcli.main(["train", "--recipe", "tiny", "--platform", "cpu",
                      "--workdir", str(tmp_path), "--max-steps", "1",
                      "--log-every", "0", "--pipeline", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["recipe"] == "tiny" and np.isfinite(line["best_loss"])
    if torch.cuda.device_count() < 2:
        assert tcli.main(["train", "--recipe", "tiny", "--pipeline",
                          "2"]) == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith(
            "error: --pipeline 2: pipeline mesh needs exactly 2 devices, "
            f"got {torch.cuda.device_count()}")
