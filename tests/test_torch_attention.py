"""The port's attention (maskunet_tpu_torch.ops) against the JAX package.

The JAX flash path runs its Pallas kernel in interpret mode on the CPU (as
tests/test_attention.py does); the port's `flash_mha` runs the kernel's
plain version there. Same numpy inputs into both. Tolerances: f32 results
agree to 2e-5 (summation order only); bf16 results to two bf16 steps of
the output magnitude; compaction plans exactly.

pyproject's `error::DeprecationWarning:maskunet_tpu` filter also matches
`maskunet_tpu_torch` (unanchored regex): the port avoids deprecated torch
calls instead of editing the filter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.ops import attention as ja
from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu_torch.ops import attention as ta
from maskunet_tpu_torch.ops import flash_attention as tfa

F32 = dict(rtol=2e-5, atol=2e-5)


def _port_params(jp: dict) -> dict:
    """JAX attention params -> the port's reference-named dict."""
    out = {}
    for name in ("query", "key", "value"):
        out[f"{name}.weight"] = torch.from_numpy(
            np.asarray(jp[name]["kernel"]).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(np.array(jp[name]["bias"]))
    out["norm.weight"] = torch.from_numpy(np.array(jp["norm"]["scale"]))
    out["norm.bias"] = torch.from_numpy(np.array(jp["norm"]["offset"]))
    return out


def _setup(b=2, l=256, c=64, seed=0):
    rng = np.random.default_rng(seed)
    jp = ja.attention_init(jax.random.key(seed), c)
    tokens = rng.standard_normal((b, l, c)).astype(np.float32)
    mask = rng.integers(0, 2, (b, l)).astype(bool)
    return jp, tokens, mask


def _bf16_close(got: torch.Tensor, want, steps: float = 2.0):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = steps * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("with_mask", [True, False])
def test_dense_matches_jax(with_mask):
    jp, tokens, mask = _setup()
    m = mask if with_mask else None
    want = ja.masked_attention_dense(jp, jnp.asarray(tokens),
                                     None if m is None else jnp.asarray(m))
    got = ta.masked_attention_dense(
        _port_params(jp), torch.from_numpy(tokens),
        None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_masked_softmax_fully_masked_row_is_zero():
    scores = torch.randn(2, 3, 5)
    mask = torch.tensor([[False] * 5, [True, False, True, False, True]])
    w = ta.masked_softmax(scores, mask)
    assert torch.equal(w[0], torch.zeros(3, 5))
    np.testing.assert_allclose(w[1].sum(-1).numpy(), np.ones(3), rtol=1e-6)


@pytest.mark.parametrize("l,density", [(4096, 0.5), (512, 0.5), (512, 0.9)])
def test_plan_compaction_identical_to_jax(l, density):
    rng = np.random.default_rng(l)
    mask = rng.random((3, l)) < density
    mask[2] = False                           # an empty row: bad
    jplan = jfa.plan_compaction(jnp.asarray(mask), density=density)
    tplan = tfa.plan_compaction(torch.from_numpy(mask), density=density)
    assert tfa._key_capacity(l, density) == jfa._key_capacity(l, density)
    np.testing.assert_array_equal(tplan.idx.numpy(), np.asarray(jplan.idx))
    np.testing.assert_array_equal(tplan.valid.numpy(),
                                  np.asarray(jplan.valid))
    np.testing.assert_array_equal(tplan.bad.numpy(), np.asarray(jplan.bad))
    assert tplan.bad[:, 0].tolist() == [False, False, True]


def test_key_capacity_serving_sizes():
    assert tfa._key_capacity(16384) == 9216
    assert tfa._key_capacity(4096) == 2560


@pytest.mark.parametrize("case", ["overflow", "empty"])
def test_compaction_poisons_bad_rows(case):
    rng = np.random.default_rng(1)
    l, c = 2048, 64                           # capacity 1536 < 2048
    k = torch.from_numpy(rng.standard_normal((2, l, c)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, l, c)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, l)) < 0.5)
    mask[1] = case == "overflow"              # all kept (> cap) or none
    k_c, v_c, valid = tfa.compact_keys(k, v, mask)
    assert torch.isnan(k_c[1]).all() and not torch.isnan(k_c[0]).any()
    assert not torch.isnan(v_c).any()
    q = torch.from_numpy(rng.standard_normal((2, 16, c)).astype(np.float32))
    out = tfa.flash_mha(q, k_c, v_c, tfa.mask_to_bias(valid, 2, valid.shape[1]),
                        1.0, use_valid=False)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_small_with_fully_masked_row(dtype):
    """B2, L256, C64, use_valid; row 1 of the mask sees no key (-> 0)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 256, 64)).astype(np.float32)
               for _ in range(3))
    mask = rng.integers(0, 2, (2, 256)).astype(bool)
    mask[1] = False
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk_, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt)
                  for t in (tq, tk_, tv))
    scale = 1.0 / 8.0
    want = jfa.flash_mha(jq, jk, jv, jfa.mask_to_bias(jnp.asarray(mask), 2,
                                                      256), scale, True)
    got = tfa.flash_mha(tq, tk_, tv,
                        tfa.mask_to_bias(torch.from_numpy(mask), 2, 256),
                        scale, True)
    assert got.dtype == tdt
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    else:
        _bf16_close(got, want)


def test_flash_mha_compacted_4096():
    """B1, L4096 queries against the 2560 compacted key slots, C64,
    use_valid=False: the attn1/attn5 serving shape at batch 1."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 4096, 64)).astype(np.float32)
               for _ in range(3))
    mask = rng.integers(0, 2, (1, 4096)).astype(bool)
    jk, jv, jvalid = jfa.compact_keys(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(mask))
    assert jk.shape == (1, 2560, 64)
    want = jfa.flash_mha(jnp.asarray(q), jk, jv,
                         jfa.mask_to_bias(jvalid, 1, 2560), 1.0 / 8.0, False)
    tk_, tv, tvalid = tfa.compact_keys(torch.from_numpy(k),
                                       torch.from_numpy(v),
                                       torch.from_numpy(mask))
    got = tfa.flash_mha(torch.from_numpy(q), tk_, tv,
                        tfa.mask_to_bias(tvalid, 1, 2560), 1.0 / 8.0, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_mha_clamp_at_60():
    """Scores past the 2^60 clamp saturate (finite, a convex combination of
    V rows) exactly as the TPU kernel does."""
    rng = np.random.default_rng(4)
    q = np.full((1, 128, 64), 40.0, np.float32)
    v = rng.standard_normal((1, 128, 64)).astype(np.float32)
    bias = np.zeros((1, 1, 128), np.float32)
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v),
                         jnp.asarray(bias), 1.0)
    got = tfa.flash_mha(torch.from_numpy(q), torch.from_numpy(q),
                        torch.from_numpy(v), torch.from_numpy(bias), 1.0)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_mha_forward_only():
    """With no gradient to take, flash_mha runs K1's forward only (no
    autograd node); under autograd it runs `_FlashMHA` (K2 forward, K4
    backward), which computes the same forward."""
    q = torch.randn(1, 16, 64, requires_grad=True)
    k, v = torch.randn(1, 16, 64), torch.randn(1, 16, 64)
    bias = torch.zeros(1, 1, 16)
    with torch.no_grad():
        out = tfa.flash_mha(q, k, v, bias, 1.0)
    assert out.shape == (1, 16, 64) and out.grad_fn is None
    out_grad = tfa.flash_mha(q, k, v, bias, 1.0)
    assert type(out_grad.grad_fn).__name__ == "_FlashMHABackward"
    assert torch.equal(out_grad.detach(), out)
    out_grad.sum().backward()
    assert q.grad.shape == q.shape and k.grad is None


def test_masked_attention_flash_compacted(monkeypatch):
    """Compaction on at 512 tokens in both packages (COMPACT_MIN_TOKENS
    lowered), plus an uncompacted case with a mask and one without."""
    monkeypatch.setattr(jfa, "COMPACT_MIN_TOKENS", 256)
    monkeypatch.setattr(tfa, "COMPACT_MIN_TOKENS", 256)
    for l, with_mask in ((512, True), (128, True), (128, False)):
        jp, tokens, mask = _setup(b=2, l=l, c=64, seed=l)
        m = mask if with_mask else None
        want = jfa.masked_attention_flash(
            jp, jnp.asarray(tokens), None if m is None else jnp.asarray(m))
        got = tfa.masked_attention_flash(
            _port_params(jp), torch.from_numpy(tokens),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    plan = tfa.plan_compaction(torch.from_numpy(mask))
    planned = tfa.masked_attention_flash(
        _port_params(jp), torch.from_numpy(tokens), torch.from_numpy(mask),
        plan=plan)
    inline = tfa.masked_attention_flash(
        _port_params(jp), torch.from_numpy(tokens), torch.from_numpy(mask))
    assert torch.equal(planned, inline)


@pytest.mark.parametrize("layout", ["transpose", "literal_view"])
def test_spatial_attention_layouts(layout):
    b, h, w, c = 2, 4, 4, 64
    jp, tokens, mask = _setup(b=b, l=h * w, c=c, seed=7)
    x = tokens.reshape(b, h, w, c)
    want = ja.spatial_attention(jp, jnp.asarray(x), jnp.asarray(mask),
                                impl="flash", output_layout=layout)
    got = ta.spatial_attention(_port_params(jp), torch.from_numpy(x),
                               torch.from_numpy(mask), impl="flash",
                               output_layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    with pytest.raises(ValueError):
        ta.spatial_attention(_port_params(jp), torch.from_numpy(x), None,
                             output_layout="bogus")


def test_random_key_mask_stats():
    m = ta.random_key_mask(torch.Generator().manual_seed(0), 4, 4096)
    assert m.dtype == torch.bool and 0.45 < m.float().mean() < 0.55
