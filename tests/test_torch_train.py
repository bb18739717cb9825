"""One training step of the port against the JAX package's `make_train_step`.

The slice as a whole at a small size: c_out 4, 16x16 images, batch 2, the
JAX weights (`from_jax`), the same cached masks and plans, the same batch
and the same dropout keep masks (`dropout_keep_mask` is replaced in both
packages by one returning the test's numpy masks by shape; nothing in the
JAX package changes). COMPACT_MIN_TOKENS is lowered to 64 in both packages,
so attn1/5/6 take the compacted, `use_valid=False` path. JAX's Pallas
kernels run in interpret mode, the port's flash wrappers their plain
versions. JAX's gradients come out of its own step: an optax stage ahead
of AdamW keeps the gradient tree in the optimizer state.

Tolerances (f32):
- loss and ce_loss 1e-5 relative; mIoU 1e-3; new BN running stats 1e-5;
- gradients per tensor: max|diff| <= 2e-4 max|g_JAX| (f32 noise through
  ~30 layers of backward) + 1e-6 of the step's largest gradient. The
  second term is the absolute f32 noise floor: some tensors' gradient is
  zero in exact arithmetic (a bias or scale feeding a BatchNorm, each
  attention's key bias under softmax's shift invariance, the conv bias
  before the final BN) and small ones come out of cancelling sums; both
  packages return noise there, measured up to 2.1e-7 of the largest
  gradient;
- parameters after the step within 1e-3 lr. AdamW's first step is
  lr g/(|g| + eps), the sign of g: entries whose gradient is at the noise
  floor flip sign with it and move by up to 2 lr either way. Measured, all
  such entries have |g| < 3e-4 max|g| of their tensor; entries below 1e-3
  max|g| of their tensor, and the tensors of noise above (max|g| < 1e-3
  of the step's largest gradient), are exempt.

bf16: JAX's own bf16 gradients reach a cosine of only ~0.88 against its
f32 gradients at this size (batch statistics over 8 pixels at the
bottleneck amplify bf16 rounding), so the two bf16 runs cannot agree to a
cosine of 0.98 with each other. The bf16 step is held to: loss within 2%
of JAX's bf16 loss, and for every tensor of >= 64 entries whose gradient
is not zero in exact arithmetic, cosine(port bf16, JAX f32) >=
cosine(JAX bf16, JAX f32) - 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskunet_tpu.core import layers as jlayers
from maskunet_tpu.core import state as jstate
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu.train import step as jstep
from maskunet_tpu_torch.core import layers as tlayers
from maskunet_tpu_torch.core import state as tstate
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.train import step as tstep
from maskunet_tpu_torch.utils import jax_weights

B, IMG, NC = 2, 16, 4
LR, WD = 1e-3, 0.1
ZERO_GRAD = 1e-3      # x the largest gradient: below it, exact zero + noise


def _record_grads():
    """optax stage that keeps the incoming gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


class Setup:
    """Weights, masks, batch and dropout masks made once from seeds (numpy
    arrays), and the context that patches both packages alike."""

    def __init__(self, batch=B):
        rng = np.random.default_rng(0)
        self.cfg = jmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG,
                                          attn_impl="flash")
        init = jax.jit(jmu.init, static_argnums=1)
        self.params, self.mstate = jax.tree.map(
            np.asarray, init(jax.random.key(0), self.cfg))
        self.batch = batch
        self.x = rng.standard_normal((batch, IMG, IMG, 3)).astype(np.float32)
        self.y = rng.integers(0, NC, (batch, IMG, IMG))
        self.keep = {s: rng.random(s) >= 0.3
                     for s in jmu.decoder_dropout_shapes(self.cfg, batch)}

    def masks(self, micro):
        return tuple(np.asarray(m) for m in jmu.make_attention_masks(
            jax.random.key(1), micro, IMG))

    def patch(self, mp):
        mp.setattr(jfa, "COMPACT_MIN_TOKENS", 64)
        mp.setattr(tfa, "COMPACT_MIN_TOKENS", 64)
        keep = self.keep
        mp.setattr(jlayers, "dropout_keep_mask",
                   lambda r, rate, shape: jnp.asarray(keep[tuple(shape)]))
        mp.setattr(tlayers, "dropout_keep_mask",
                   lambda g, rate, shape: torch.from_numpy(
                       keep[tuple(shape)]))

    def jax_step(self, grad_accum=1):
        """JAX make_train_step: (grads, metrics, params, model_state) as
        numpy trees."""
        masks = tuple(map(jnp.asarray, self.masks(self.batch // grad_accum)))
        tx = optax.chain(_record_grads(), optax.adamw(LR, weight_decay=WD))
        ts = jstate.create(jax.random.key(2),
                           jax.tree.map(jnp.asarray, self.params),
                           jax.tree.map(jnp.asarray, self.mstate), tx,
                           masks=masks)
        step = jax.jit(jstep.make_train_step(
            self.cfg, jstep.TaskConfig(), tx, grad_accum=grad_accum,
            mask_plans=jmu.precompute_mask_plans(masks)))
        ts, metrics = step(ts, {"image": jnp.asarray(self.x),
                                "label": jnp.asarray(self.y)})
        as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        return (as_np(ts.opt_state[0]), {k: float(v) for k, v in
                                         metrics.items()},
                as_np(ts.params), as_np(ts.model_state))

    def port_state(self, cfg, micro):
        tp, ts_ = jax_weights.from_jax(self.params, self.mstate, cfg)
        recipe = dataclasses.replace(trecipes.get("ade_semantic"), lr=LR,
                                     weight_decay=WD)
        masks = tuple(torch.from_numpy(m.copy()) for m in self.masks(micro))
        return tstate.create(torch.Generator().manual_seed(0), tp, ts_,
                             tloop.make_optimizer(recipe), masks=masks)

    def port_batch(self):
        return {"image": torch.from_numpy(self.x),
                "label": torch.from_numpy(self.y)}


def port_grads(setup, cfg):
    ts = setup.port_state(cfg, setup.batch)
    gm = tstep.make_grads_and_metrics(cfg, tstep.TaskConfig())
    grads, metrics, _ = gm(ts.params, ts.model_state, setup.port_batch(),
                           ts.masks, tmu.precompute_mask_plans(ts.masks),
                           ts.generator)
    return ({k: v.numpy() for k, v in grads.items()},
            {k: float(v) for k, v in metrics.items()})


def port_step(setup, grad_accum=1):
    cfg = tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG)
    ts = setup.port_state(cfg, setup.batch // grad_accum)
    step = tstep.make_train_step(cfg, tstep.TaskConfig(),
                                 grad_accum=grad_accum,
                                 mask_plans=tmu.precompute_mask_plans(
                                     ts.masks), device="cpu")
    ts, metrics = step(ts, setup.port_batch())
    assert ts.step == 1
    return ({k: v.detach().numpy() for k, v in ts.params.items()},
            {k: v.numpy() for k, v in ts.model_state.items()},
            {k: float(v) for k, v in metrics.items()})


def compare_step(setup, jres, pres):
    """The checks of the module docstring, f32."""
    jgrads, jmetrics, jparams, jmstate = jres
    tparams, tmstate, tmetrics = pres
    cfg = tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG)
    for key in ("loss", "ce_loss"):
        np.testing.assert_allclose(tmetrics[key], jmetrics[key], rtol=1e-5)
    assert abs(tmetrics["miou"] - jmetrics["miou"]) <= 1e-3
    want_p, want_s = jax_weights.from_jax(jparams, jmstate, cfg)
    grads, _ = jax_weights.from_jax(jgrads, setup.mstate, cfg)
    for key, want in want_s.items():
        np.testing.assert_allclose(tmstate[key], want.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    gmax = max(float(np.abs(g.numpy()).max()) for g in grads.values())
    for key, want in want_p.items():
        g = np.abs(grads[key].numpy())
        if g.max() < ZERO_GRAD * gmax:
            continue
        moved = g >= 1e-3 * g.max()
        np.testing.assert_allclose(tparams[key][moved], want.numpy()[moved],
                                   atol=1e-3 * LR, rtol=0, err_msg=key)


def compare_grads(got: dict, jgrads, setup):
    cfg = tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG)
    want, _ = jax_weights.from_jax(jgrads, setup.mstate, cfg)
    assert set(got) == set(want)
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for key, w in want.items():
        w = w.numpy()
        bound = 2e-4 * float(np.abs(w).max()) + 1e-6 * gmax
        assert np.abs(got[key] - w).max() <= bound, key


@pytest.fixture(scope="module")
def f32_step():
    setup = Setup()
    with pytest.MonkeyPatch.context() as mp:
        setup.patch(mp)
        jres = setup.jax_step()
        grads, _ = port_grads(setup, tmu.MaskAttnUNetConfig(c_out=NC,
                                                            img_size=IMG))
        pres = port_step(setup)
    return setup, jres, grads, pres


def test_train_step_matches_jax_f32(f32_step):
    setup, jres, _, pres = f32_step
    compare_step(setup, jres, pres)


def test_grads_match_jax_f32(f32_step):
    setup, jres, grads, _ = f32_step
    compare_grads(grads, jres[0], setup)


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def test_bf16_step_matches_jax(f32_step, monkeypatch):
    setup, (jgrads_f32, *_), _, _ = f32_step
    setup.patch(monkeypatch)
    cfg = tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG,
                                 compute_dtype="bfloat16")
    jcfg = dataclasses.replace(setup.cfg, compute_dtype="bfloat16")
    masks = tuple(map(jnp.asarray, setup.masks(B)))
    batch = {"image": jnp.asarray(setup.x), "label": jnp.asarray(setup.y)}

    def loss_fn(p):
        out, _ = jmu.apply(p, jax.tree.map(jnp.asarray, setup.mstate),
                           batch["image"], cfg=jcfg, masks=masks, train=True,
                           dropout_rng=jax.random.key(3),
                           mask_plans=jmu.precompute_mask_plans(masks))
        return jstep._compute_loss(out, batch, jstep.TaskConfig(), None)[0]

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, setup.params))
    grads, metrics = port_grads(setup, cfg)
    assert abs(metrics["loss"] - float(jloss)) <= 0.02 * abs(float(jloss))
    jg, _ = jax_weights.from_jax(jax.tree.map(np.asarray, jg),
                                 setup.mstate, cfg)
    f32, _ = jax_weights.from_jax(jgrads_f32, setup.mstate, cfg)
    gmax = max(float(np.abs(g.numpy()).max()) for g in f32.values())
    checked = 0
    for key, truth in f32.items():
        truth = truth.numpy()
        if truth.size < 64 or np.abs(truth).max() < ZERO_GRAD * gmax:
            continue
        assert np.isfinite(grads[key]).all(), key
        assert (_cos(grads[key], truth)
                >= _cos(jg[key].numpy(), truth) - 0.05), key
        checked += 1
    assert checked > 100


def test_remat_attention_same_loss_and_grads(monkeypatch):
    """Recomputing the attention blocks in the backward (non-reentrant
    checkpoint) changes nothing: 1e-6, as tests/test_train.py holds JAX."""
    setup = Setup()
    setup.patch(monkeypatch)
    plain = port_grads(setup, tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG))
    remat = port_grads(setup, tmu.MaskAttnUNetConfig(
        c_out=NC, img_size=IMG, remat_attention=True))
    assert abs(plain[1]["loss"] - remat[1]["loss"]) <= 1e-6
    for key, g in plain[0].items():
        np.testing.assert_allclose(remat[0][key], g, atol=1e-6, rtol=1e-6,
                                   err_msg=key)


def test_fresh_masks_and_setup_state_on_cpu():
    """setup_state on the CPU, then two steps with masks drawn per step
    from the state's generator and planned in the step."""
    recipe = dataclasses.replace(trecipes.get("synthetic_semantic"),
                                 img_size=IMG)
    cfg = tloop.model_config(recipe, NC)
    ts = tloop.setup_state(recipe, cfg, tloop.make_optimizer(recipe),
                           batch_size=B, device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in ts.params.values())
    assert [m.shape for m in ts.masks] == [
        (B, n) for n in tmu.attention_mask_sizes(IMG)]
    step = tstep.make_train_step(
        cfg, dataclasses.replace(tstep.TaskConfig(), mask_policy="fresh"),
        device="cpu")
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((B, IMG, IMG, 3)).astype(
        np.float32), "label": rng.integers(0, NC, (B, IMG, IMG))}
    masks0 = ts.masks
    before = ts.params["final_layer.0.weight"].detach().clone()
    for _ in range(2):
        ts, metrics = step(ts, batch)
        assert np.isfinite(float(metrics["loss"]))
    assert ts.step == 2
    assert not all(torch.equal(a, b) for a, b in zip(ts.masks, masks0))
    assert not torch.equal(ts.params["final_layer.0.weight"], before)


def test_train_paths_of_later_slices_raise():
    cfg = tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG)
    blend = tstep.TaskConfig(triplet_weight=0.1)   # ported: builds
    assert callable(tstep.make_train_step(cfg, blend, device="cpu"))
    assert callable(tstep.make_eval_step(cfg, blend, device="cpu"))
    # the parallel slices are ported: a data mesh, a (data, model) mesh
    # and a pipe mesh build steps; JAX's refusals stay: a pipe mesh with a
    # (TP) mesh, and a mesh without the pipe axis
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.parallel import pipeline as pp
    tp = mesh_lib.make_mesh(1, n_model=2, devices=["cpu", "cpu"])
    for mesh in (mesh_lib.make_mesh(1, devices=["cpu"]), tp):
        assert callable(tstep.make_train_step(
            cfg, tstep.TaskConfig(), device="cpu", mesh=mesh))
    pipe = pp.make_pipe_mesh(devices=["cpu", "cpu"])
    assert callable(tstep.make_train_step(
        cfg, tstep.TaskConfig(), device="cpu", pipe_microbatches=2,
        pipe_mesh=pipe))
    with pytest.raises(ValueError, match="not both"):
        tstep.make_train_step(cfg, tstep.TaskConfig(), device="cpu",
                              mesh=tp, pipe_mesh=pipe, pipe_microbatches=2)
    with pytest.raises(ValueError, match="a 'pipe' axis"):
        tstep.make_train_step(cfg, tstep.TaskConfig(), pipe_mesh=object(),
                              device="cpu")
    with pytest.raises(ValueError, match="eval-only"):
        tmu.apply({}, None, torch.zeros(1, IMG, IMG, 3), cfg=cfg,
                  train=True, folded=True)


def test_train_entry_points_default_to_the_card():
    """Without a card, the default device raises instead of falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    recipe = trecipes.get("synthetic_semantic")
    cfg = tloop.model_config(recipe, NC)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.make_train_step(cfg, tstep.TaskConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.make_eval_step(cfg, tstep.TaskConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.setup_state(recipe, cfg, tloop.make_optimizer(recipe))
