"""The port's safe-softmax path against the JAX package's, with the switch on.

MASKUNET_SAFE_SOFTMAX=1 (`_SAFE_SOFTMAX`, monkeypatched in both packages as
tests/test_attention.py does) puts the online-max forward (K3) on the
serving and training paths and runs the backward (K4) without its clamp.
Here K3's plain version (`flash_fwd_online_reference`) is held to JAX's
`_flash_fwd(need_lse=True)`, K4's plain version with `clamp=False` to JAX's
`_flash_bwd`, and `masked_attention_flash` and the model's eval forward and
loss gradients to JAX's, all under the switch. JAX's Pallas kernels run in
interpret mode on the CPU; the same numpy inputs go into both packages.

Tolerances:
- f32: 1e-5 of each output's max|.| (summation order only);
- bf16: max|diff| <= 2^-6 max|JAX| and rms(diff) <= 2^-7 rms(JAX) (the two
  round the same f32 values to bf16 at different points, one bf16 step of
  2^-8 relative each);
- lse of a fully masked row: exactly f32(-1e30) in both (m + log2 l with m
  = -1e30 leaves nothing of the log);
- layer gradients 5e-4 and the model's as tests/test_torch_train.py holds
  them (2e-4 of each tensor's max + 1e-6 of the step's largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.ops import attention as ja
from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu.train import step as jstep
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.ops import flash_kernels as tk

from test_torch_attention import _port_params
from test_torch_flash_bwd import _both, _close
from test_torch_train import IMG, NC, Setup, compare_grads, port_grads

NEG_INF32 = float(np.float32(-1e30))


@pytest.fixture
def safe(monkeypatch):
    """The switch on in both packages."""
    monkeypatch.setattr(jfa, "_SAFE_SOFTMAX", True)
    monkeypatch.setattr(tfa, "_SAFE_SOFTMAX", True)


def _inputs(l, c, seed, *, row1=None, use_valid=True, big=False):
    """q (scaled by C^-1/2), k, v, dO and the bias, batch 2. `row1`:
    'masked' masks every key of batch row 1, 'nan' poisons its K.
    `big` puts base-2 scores far past 60 on some queries."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((2, l, c)).astype(np.float32)
                   for _ in range(4))
    q *= c ** -0.5
    if big:
        q[0, :8] *= 40.0
    mask = rng.integers(0, 2, (2, l)).astype(bool)
    if not use_valid:
        mask[:] = True
    if row1 == "masked":
        mask[1] = False
    if row1 == "nan":
        k[1] = np.nan
    bias = np.where(mask[:, None, :], 0.0, -1e30).astype(np.float32)
    return q, k, v, do, bias


def _jax_fwd(jq, jk, jv, bias, use_valid):
    return jfa._flash_fwd(jq, jk, jv, jnp.asarray(bias), 1.0, use_valid,
                          need_lse=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_valid", [True, False])
@pytest.mark.parametrize("row1", [None, "masked", "nan"])
def test_online_forward_plain_matches_jax(safe, row1, use_valid, dtype):
    """o and lse of K3's plain version against JAX's online-max kernel.
    A fully masked row gives o = 0 with use_valid and the mean of V
    without, lse = -1e30 either way; a NaN-poisoned K gives NaN."""
    l, c = (512, 64) if row1 is None else (256, 128)
    q, k, v, _, bias = _inputs(l, c, l + c, row1=row1)
    (jq, jk, jv), (tq, tk_, tv) = _both((q, k, v), dtype)
    want_o, want_lse = _jax_fwd(jq, jk, jv, bias, use_valid)
    o, lse = tk.flash_fwd_online_reference(tq, tk_, tv,
                                           torch.from_numpy(bias), 1.0,
                                           use_valid)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == (2, 1, l)
    _close(o, want_o, dtype)
    _close(lse[0], np.asarray(want_lse)[0], "float32")
    if row1 == "nan":
        assert torch.isnan(o[1]).all() and torch.isnan(lse[1]).all()
        assert torch.isfinite(o[0]).all()
    elif row1 == "masked":
        assert (lse[1] == NEG_INF32).all()
        assert (np.asarray(want_lse)[1] == NEG_INF32).all()
        if use_valid:
            assert torch.equal(o[1], torch.zeros_like(o[1]))
        else:                        # JAX's semantics: the mean of V
            mean_v = tv[1].float().mean(dim=0).expand(l, c)
            _close(o[1], mean_v.numpy(), dtype)
    else:
        _close(lse[1], np.asarray(want_lse)[1], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["valid", "compacted", "above_clamp"])
def test_backward_without_clamp_plain_matches_jax(safe, case, dtype):
    """K4's plain version with clamp=False, on the online-max forward's o
    and lse, against JAX's `_flash_bwd` under the switch (its kernel then
    runs with clamp=False)."""
    use_valid = case != "compacted"
    q, k, v, do, bias = _inputs(512, 64, 7 + len(case), use_valid=use_valid,
                                big=case == "above_clamp")
    (jq, jk, jv, jdo), (tq, tk_, tv, tdo) = _both((q, k, v, do), dtype)
    o, lse = _jax_fwd(jq, jk, jv, bias, use_valid)
    if case == "above_clamp":
        assert float(jnp.max(lse)) > 60.0
    want = jfa._flash_bwd(jq, jk, jv, jnp.asarray(bias), o, lse, jdo, 1.0,
                          use_valid)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(tq.dtype)
    tl = torch.from_numpy(np.array(lse))
    got = tk.flash_bwd_reference(tq, tk_, tv, torch.from_numpy(bias), to, tl,
                                 tdo, 1.0, use_valid, clamp=False)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype and torch.isfinite(g).all()
        _close(g, w, dtype)
    if case == "above_clamp":        # the clamp would have changed them
        clamped = tk.flash_bwd_reference(tq, tk_, tv, torch.from_numpy(bias),
                                         to, tl, tdo, 1.0, use_valid)
        assert not torch.allclose(clamped[0].float(), got[0].float())


@pytest.mark.parametrize("compact", [True, False])
def test_masked_attention_flash_safe_matches_jax(safe, monkeypatch, compact):
    """Forward and d sum(out^2) / d (params, tokens) of the attention
    layer through K3 + K4 (clamp off) against JAX's, compaction on at 512
    tokens in both packages when `compact`."""
    if compact:
        monkeypatch.setattr(jfa, "COMPACT_MIN_TOKENS", 256)
        monkeypatch.setattr(tfa, "COMPACT_MIN_TOKENS", 256)
    rng = np.random.default_rng(6)
    jp = ja.attention_init(jax.random.key(6), 64)
    tokens = rng.standard_normal((2, 512, 64)).astype(np.float32)
    mask = rng.integers(0, 2, (2, 512)).astype(bool)

    def jloss(p, t):
        return jnp.sum(jnp.square(jfa.masked_attention_flash(
            p, t, jnp.asarray(mask))))

    jout = jfa.masked_attention_flash(jp, jnp.asarray(tokens),
                                      jnp.asarray(mask))
    jgp, jgt = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(tokens))
    tp = {k: v.requires_grad_() for k, v in _port_params(jp).items()}
    tt = torch.from_numpy(tokens).requires_grad_()
    out = tfa.masked_attention_flash(tp, tt, torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    out.square().sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt),
                               atol=5e-4, rtol=5e-4)
    for key, g in _port_params(jgp).items():
        np.testing.assert_allclose(tp[key].grad.numpy(), g.numpy(),
                                   atol=5e-4, rtol=5e-4, err_msg=key)


def test_safe_and_default_paths_differ_above_clamp(monkeypatch):
    """Base-2 scores far past 60: the default path saturates them at the
    clamp, the safe path takes the true softmax. The port's two paths give
    JAX's two results (forward and gradients), and differ from each
    other as JAX's do."""
    rng = np.random.default_rng(8)
    q, k, v, do = (rng.standard_normal((1, 128, 64)).astype(np.float32)
                   for _ in range(4))
    q *= 4.0                                 # |s2| up to ~200
    bias = np.zeros((1, 1, 128), np.float32)
    results = {}
    for safe in (False, True):
        monkeypatch.setattr(jfa, "_SAFE_SOFTMAX", safe)
        monkeypatch.setattr(tfa, "_SAFE_SOFTMAX", safe)

        def jloss(q_, k_, v_):
            return jnp.sum(jfa.flash_mha(q_, k_, v_, jnp.asarray(bias), 1.0)
                           * jnp.asarray(do))

        jo = jfa.flash_mha(*map(jnp.asarray, (q, k, v, bias)), 1.0)
        jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        to = tfa.flash_mha(tq, tk_, tv, torch.from_numpy(bias), 1.0)
        (to * torch.from_numpy(do)).sum().backward()
        _close(to.detach(), jo, "float32")
        for t, w in zip((tq, tk_, tv), jg):
            _close(t.grad, w, "float32")
        results[safe] = to.detach()
    assert float((results[True] - results[False]).abs().max()) > 0.1


def test_switch_dispatch_and_backward_flag(monkeypatch):
    """Which kernel each path calls: K1 / K2 + clamped K4 by default, K3
    (both) + unclamped K4 under the switch; the backward follows the
    switch as its forward saw it, not as it is when the backward runs."""
    calls = []

    def record(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, kw.get("clamp")))
            return fn(*args, **kw)
        monkeypatch.setattr(tk, name, wrapped)

    for name in ("flash_fwd_nomax", "flash_fwd_nomax_lse",
                 "flash_fwd_online", "flash_bwd"):
        record(name, getattr(tk, name))
    q, k, v = (torch.randn(1, 32, 64) for _ in range(3))
    bias = torch.zeros(1, 1, 32)
    for safe, fwd, grad_fwd in ((False, "flash_fwd_nomax",
                                 "flash_fwd_nomax_lse"),
                                (True, "flash_fwd_online",
                                 "flash_fwd_online")):
        monkeypatch.setattr(tfa, "_SAFE_SOFTMAX", safe)
        calls.clear()
        with torch.no_grad():
            tfa.flash_mha(q, k, v, bias, 1.0)
        assert calls == [(fwd, None)]
        calls.clear()
        out = tfa.flash_mha(q.clone().requires_grad_(), k, v, bias, 1.0)
        monkeypatch.setattr(tfa, "_SAFE_SOFTMAX", not safe)
        out.sum().backward()
        assert calls == [(grad_fwd, None), ("flash_bwd", not safe)]


@pytest.fixture(scope="module")
def model_setup():
    return Setup()


def test_model_eval_forward_safe_matches_jax(model_setup, monkeypatch):
    """The eval forward at img 16 on JAX's weights, the switch on and
    compaction on at 64 tokens in both packages."""
    setup = model_setup
    setup.patch(monkeypatch)
    monkeypatch.setattr(jfa, "_SAFE_SOFTMAX", True)
    monkeypatch.setattr(tfa, "_SAFE_SOFTMAX", True)
    masks = setup.masks(setup.batch)
    jmasks = tuple(map(jnp.asarray, masks))
    want = jax.jit(lambda p, s, x: jmu.apply(
        p, s, x, cfg=setup.cfg, masks=jmasks, train=False,
        mask_plans=jmu.precompute_mask_plans(jmasks))[0].semantic)(
            setup.params, setup.mstate, setup.x)
    ts = setup.port_state(tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG),
                          setup.batch)
    with torch.no_grad():
        got, _ = tmu.apply(ts.params, ts.model_state,
                           torch.from_numpy(setup.x),
                           cfg=tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG),
                           masks=ts.masks,
                           mask_plans=tmu.precompute_mask_plans(ts.masks))
    np.testing.assert_allclose(got.semantic.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_model_loss_grads_safe_match_jax(model_setup, monkeypatch):
    """d loss / d params of the training forward (train BN, the same
    dropout keep masks) under the switch: JAX's value_and_grad against the
    port's `make_grads_and_metrics`, f32."""
    setup = model_setup
    setup.patch(monkeypatch)
    monkeypatch.setattr(jfa, "_SAFE_SOFTMAX", True)
    monkeypatch.setattr(tfa, "_SAFE_SOFTMAX", True)
    jmasks = tuple(map(jnp.asarray, setup.masks(setup.batch)))
    batch = {"image": jnp.asarray(setup.x), "label": jnp.asarray(setup.y)}

    def loss_fn(p):
        out, _ = jmu.apply(p, jax.tree.map(jnp.asarray, setup.mstate),
                           batch["image"], cfg=setup.cfg, masks=jmasks,
                           train=True, dropout_rng=jax.random.key(3),
                           mask_plans=jmu.precompute_mask_plans(jmasks))
        return jstep._compute_loss(out, batch, jstep.TaskConfig(), None)[0]

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, setup.params))
    grads, metrics = port_grads(setup, tmu.MaskAttnUNetConfig(
        c_out=NC, img_size=IMG))
    np.testing.assert_allclose(metrics["loss"], float(jloss), rtol=1e-5)
    compare_grads(grads, jax.tree.map(np.asarray, jg), setup)
