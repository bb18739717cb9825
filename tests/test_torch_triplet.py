"""The port's triplet loss and loss blends against the JAX package's.

- `triplet_from_indices` on the indices JAX's `sample_triplets` draws: the
  loss within 1e-6 relative, its gradient with respect to the features
  (`jax.grad` against autograd) within 1e-5 max|g| (f32: the same sums in
  another order).
- The port's `sample_triplets` keeps JAX's rules (hypothesis over small
  instance maps): anchors are valid pixels (all of them when there are
  fewer than K), a usable triplet's positive is another pixel of the
  anchor's instance and its negative a pixel outside it and not ignore,
  and a triplet is usable exactly when such a positive and negative exist.
- The blended `_compute_loss` (panoptic: 0.9 CE + 0.1 triplet on the
  logits; instance: CE with ignore 255 + 0.5 triplet on the embeddings)
  against JAX's on one fixed `ModelOutput`, the port handed the triplets
  JAX draws inside its loss: the loss terms within 1e-6 relative, the
  gradients within 1e-5 max|g|.
- The eval step: padded rows' instance ids are zeroed, so their triplets
  have weight 0; the eval draws leave the state's generator alone, so a
  `train()` that validates every epoch ends on the generator state and
  the weights of one that does not; and the step makes its generator
  only for a batch whose triplet term runs (one with instance ids).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from maskunet_tpu.losses import triplet as jtri
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.train import step as jstep
from maskunet_tpu_torch.losses import triplet as ttri
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.train import step as tstep

B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host, and torch's default of a thread per core in each
    oversubscribes it (a 16 px `train()` then runs ~10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _instances(rng, ignore=False):
    inst = rng.integers(0, 5, (B, S, S)).astype(np.int32)
    inst[:, :4, :4] = 7              # one large instance per image
    if ignore:
        inst[:, -2:, :] = 255
    return inst


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("channels, ignore", [(8, False), (16, True)])
def test_triplet_from_indices_matches_jax(rng, channels, ignore):
    feats = rng.standard_normal((B, S, S, channels)).astype(np.float32)
    inst = _instances(rng, ignore)
    idx = jtri.sample_triplets(jax.random.key(3), jnp.asarray(inst),
                               ignore_label=255 if ignore else None)
    assert float(jnp.sum(idx[3])) > 0
    jloss, jgrad = jax.value_and_grad(
        lambda f: jtri.triplet_from_indices(f, *idx))(jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_()
    tidx = [torch.from_numpy(np.array(a)) for a in idx]
    tloss = ttri.triplet_from_indices(tf, *(t.long() for t in tidx[:3]),
                                      tidx[3])
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    _close(tf.grad.numpy(), jgrad, 1e-5)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), h=st.integers(2, 7),
       w=st.integers(2, 7), b=st.integers(1, 3),
       k=st.integers(1, 4), ignore=st.booleans())
def test_sampler_keeps_the_jax_rules(seed, h, w, b, k, ignore):
    rng = np.random.default_rng(seed)
    ids = rng.choice([0, 1, 2, 3, 255] if ignore else [0, 1, 2, 3],
                     (b, h, w)).astype(np.int32)
    gen = torch.Generator().manual_seed(seed)
    a, p, n, wt = (t.numpy() for t in ttri.sample_triplets(
        gen, torch.from_numpy(ids), num_samples=k,
        ignore_label=255 if ignore else None))
    flat = ids.reshape(b, h * w)
    valid = (flat != 0) & ~((flat == 255) & ignore)
    for r in range(b):
        assert len(set(a[r].tolist())) == k
        assert valid[r, a[r]].sum() == min(k, valid[r].sum())
        for j in range(k):
            anchor = flat[r, a[r, j]]
            others = np.flatnonzero(flat[r] == anchor)
            has_pos = valid[r, a[r, j]] and len(others) > 1
            outside = (flat[r] != anchor) & ~((flat[r] == 255) & ignore)
            assert wt[r, j] == float(has_pos and outside.any())
            if wt[r, j]:
                assert p[r, j] != a[r, j] and flat[r, p[r, j]] == anchor
                assert outside[n[r, j]]


@pytest.mark.parametrize("recipe", ["ade_panoptic", "city_instance"])
def test_blended_loss_matches_jax(rng, recipe):
    task = trecipes.get(recipe).task_config
    nc = 19 if recipe == "city_instance" else 8
    logits = (rng.standard_normal((B, S, S, nc)) * 2).astype(np.float32)
    emb = rng.standard_normal((B, S, S, 16)).astype(np.float32)
    labels = rng.integers(0, nc, (B, S, S)).astype(np.int32)
    labels[0, :2] = 255
    inst = _instances(rng, task.triplet_ignore_label is not None)
    key = jax.random.key(11)
    jbatch = {"label": jnp.asarray(labels), "instance": jnp.asarray(inst)}

    def jloss(sem, e):
        out = jmu.ModelOutput(semantic=sem, boundary=None, embeddings=e)
        return jstep._compute_loss(out, jbatch, task, key)

    (jl, jm), (jgs, jge) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(logits), jnp.asarray(emb))
    triplets = jtri.sample_triplets(
        key, jbatch["instance"], num_samples=task.triplet_samples,
        ignore_label=task.triplet_ignore_label)
    sem = torch.from_numpy(logits).requires_grad_()
    e = torch.from_numpy(emb).requires_grad_()
    out = tmu.ModelOutput(semantic=sem, boundary=None, embeddings=e)
    batch = {"label": torch.from_numpy(labels),
             "instance": torch.from_numpy(inst)}
    tl, tm = tstep._compute_loss(out, batch, task, None,
                                 [np.array(t) for t in triplets])
    tl.backward()
    assert set(tm) == set(jm) == {"ce_loss", "triplet_loss", "loss"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-6)
    tm = {k: float(v.detach()) for k, v in tm.items()}
    assert tm["triplet_loss"] > 0
    np.testing.assert_allclose(
        float(tl.detach()), task.ce_weight * tm["ce_loss"]
        + task.triplet_weight * tm["triplet_loss"], rtol=1e-6)
    _close(sem.grad.numpy(), jgs, 1e-5)
    if task.triplet_features == "embeddings":
        _close(e.grad.numpy(), jge, 1e-5)
    else:
        assert e.grad is None and not np.asarray(jge).any()
    # the triplet term needs instance ids: without them, CE only
    _, ce_only = tstep._compute_loss(out, {"label": batch["label"]}, task,
                                     None)
    assert set(ce_only) == {"ce_loss", "loss"}


def _panoptic_recipe():
    return dataclasses.replace(trecipes.get("synthetic_panoptic"),
                               img_size=S)


def test_eval_step_zeroes_padded_rows(monkeypatch):
    recipe = _panoptic_recipe()
    cfg = tloop.model_config(recipe, 8)
    ts = tloop.setup_state(recipe, cfg, tloop.make_optimizer(recipe),
                           batch_size=4, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"image": rng.random((4, S, S, 3), np.float32),
             "label": rng.integers(0, 8, (4, S, S)),
             "instance": rng.integers(1, 4, (4, S, S)).astype(np.int32),
             "valid": np.array([True, True, False, False])}
    drawn = []
    sample = ttri.sample_triplets

    def recorded(*args, **kw):
        drawn.append(sample(*args, **kw))
        return drawn[-1]

    monkeypatch.setattr(ttri, "sample_triplets", recorded)
    gen_state = ts.generator.get_state()
    step = tstep.make_eval_step(cfg, recipe.task_config, device="cpu")
    first = step(ts, batch)["metrics"]
    second = step(ts, batch)["metrics"]
    weight = drawn[0][3]
    assert weight[:2].sum() > 0 and weight[2:].sum() == 0
    # the same draws at every call, and the state's generator unmoved
    assert all(torch.equal(a, b) for a, b in zip(*drawn))
    assert float(first["triplet_loss"]) == float(second["triplet_loss"]) > 0
    assert torch.equal(ts.generator.get_state(), gen_state)


def test_validation_leaves_the_training_stream_alone(tmp_path):
    recipe = _panoptic_recipe()
    kw = dict(max_epochs=1, data_fraction=0.25, device="cpu", verbose=False,
              save_checkpoints=False, eval_max_batches=1)
    with_eval = tloop.train(recipe, None, str(tmp_path), eval_every=1, **kw)
    without = tloop.train(recipe, None, str(tmp_path), **kw)
    assert "val_triplet_loss" in with_eval.history[0]
    assert torch.equal(with_eval.state.generator.get_state(),
                       without.state.generator.get_state())
    assert all(torch.equal(p, without.state.params[k])
               for k, p in with_eval.state.params.items())


@pytest.mark.parametrize("with_instance", [False, True])
def test_eval_step_makes_a_generator_only_for_the_triplet(monkeypatch,
                                                          with_instance):
    recipe = _panoptic_recipe()
    cfg = tloop.model_config(recipe, 8)
    ts = tloop.setup_state(recipe, cfg, tloop.make_optimizer(recipe),
                           batch_size=2, device="cpu")
    rng = np.random.default_rng(6)
    batch = {"image": rng.random((2, S, S, 3), np.float32),
             "label": rng.integers(0, 8, (2, S, S))}
    if with_instance:
        batch["instance"] = rng.integers(1, 4, (2, S, S)).astype(np.int32)
    made = []
    eval_generator = tstep._eval_generator

    def counted(generator):
        made.append(generator)
        return eval_generator(generator)

    monkeypatch.setattr(tstep, "_eval_generator", counted)
    step = tstep.make_eval_step(cfg, recipe.task_config, device="cpu")
    metrics = step(ts, batch)["metrics"]
    assert len(made) == int(with_instance)
    assert ("triplet_loss" in metrics) == with_instance
