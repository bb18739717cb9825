"""The training half of the port's flash attention against the JAX package.

K2's plain version (`flash_fwd_nomax_reference(with_lse=True)`) against
JAX's `_flash_fwd(need_lse=True)`, K4's plain version
(`flash_bwd_reference`) against JAX's `_flash_bwd`, and the gradients of
`masked_attention_flash` against `jax.grad`. JAX's Pallas kernels run in
interpret mode on the CPU; the same numpy inputs go into both packages.

Tolerances:
- f32: 1e-5 of each output's max|.| (summation order only);
- bf16: max|diff| <= 2^-6 max|JAX| and rms(diff) <= 2^-7 rms(JAX) (the
  two round the same f32 values to bf16 at different points, each rounding
  one bf16 step of 2^-8 relative);
- layer gradients: 5e-4, tests/test_attention.py's own bound for the
  compacted flash gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.ops import attention as ja
from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.ops import flash_kernels as tk

from test_torch_attention import _port_params

SHAPES = [(512, 64), (384, 128), (256, 256)]      # (L, C), batch 2


def _inputs(l, c, seed, *, use_valid=True, clamp=False):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((2, l, c)).astype(np.float32)
                   for _ in range(4))
    q *= c ** -0.5
    if clamp:                        # base-2 scores past 60 on some keys
        q[0, :8] *= 40.0
    mask = rng.integers(0, 2, (2, l)).astype(bool)
    if not use_valid:
        mask[:] = True
    bias = np.where(mask[:, None, :], 0.0, -1e30).astype(np.float32)
    return q, k, v, do, bias


def _close(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    g, w = got[fin], want[fin]
    if g.size == 0:
        return
    if dtype == "float32":
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)
    else:
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        assert (np.sqrt(np.mean((g - w) ** 2))
                <= 2.0 ** -7 * np.sqrt(np.mean(w ** 2)))


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ts = [torch.from_numpy(a.copy()).to(tdt) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return js, ts


@pytest.mark.parametrize("use_valid", [True, False])
@pytest.mark.parametrize("l,c", SHAPES)
def test_lse_forward_plain_matches_jax(l, c, use_valid):
    q, k, v, _, bias = _inputs(l, c, l + c, use_valid=use_valid)
    want_o, want_lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v, bias)),
                                      1.0, use_valid, need_lse=True)
    o, lse = tk.flash_fwd_nomax_reference(
        *map(torch.from_numpy, (q, k, v, bias)), 1.0, use_valid,
        with_lse=True)
    assert lse.shape == (2, 1, l) and lse.dtype == torch.float32
    _close(o, want_o, "float32")
    _close(lse, want_lse, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["valid", "compacted", "clamp"])
@pytest.mark.parametrize("l,c", SHAPES)
def test_backward_plain_matches_jax(l, c, case, dtype):
    use_valid = case != "compacted"
    q, k, v, do, bias = _inputs(l, c, 7 * l + c, use_valid=use_valid,
                                clamp=case == "clamp")
    (jq, jk, jv, jdo), (tq, tk_, tv, tdo) = _both((q, k, v, do), dtype)
    jb, tb = jnp.asarray(bias), torch.from_numpy(bias)
    o, lse = jfa._flash_fwd(jq, jk, jv, jb, 1.0, use_valid, need_lse=True)
    want = jfa._flash_bwd(jq, jk, jv, jb, o, lse, jdo, 1.0, use_valid)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(tq.dtype)
    got = tk.flash_bwd_reference(tq, tk_, tv, tb, to,
                                 torch.from_numpy(np.array(lse)), tdo,
                                 1.0, use_valid)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_fully_masked_row_and_nan_row(dtype):
    """Row 1's mask sees no key: its dQ is exactly 0 (use_valid). A
    NaN-poisoned K (as `compact_keys` leaves a bad row) gives NaN where
    JAX gives NaN (use_valid False)."""
    q, k, v, do, bias = _inputs(256, 64, 11)
    bias[1] = -1e30
    (jq, jk, jv, jdo), (tq, tk_, tv, tdo) = _both((q, k, v, do), dtype)
    for poison in (False, True):
        if poison:
            tk_ = tk_.clone()
            tk_[1] = float("nan")
            jk = jnp.asarray(tk_.float().numpy()).astype(jk.dtype)
            b = np.zeros_like(bias)
        else:
            b = bias
        use_valid = not poison
        o, lse = jfa._flash_fwd(jq, jk, jv, jnp.asarray(b), 1.0, use_valid,
                                need_lse=True)
        want = jfa._flash_bwd(jq, jk, jv, jnp.asarray(b), o, lse, jdo, 1.0,
                              use_valid)
        got = tk.flash_bwd_reference(
            tq, tk_, tv, torch.from_numpy(b),
            torch.from_numpy(np.array(o.astype(jnp.float32))).to(tq.dtype),
            torch.from_numpy(np.array(lse)), tdo, 1.0, use_valid)
        for g, w in zip(got, want):
            _close(g, w, dtype)
        if poison:
            assert torch.isnan(got[0][1]).all() and torch.isnan(got[1][1]).all()
            assert torch.isfinite(got[0][0]).all()
        else:
            assert torch.equal(got[0][1], torch.zeros_like(got[0][1]))


@pytest.mark.parametrize("compact", [True, False])
def test_masked_attention_flash_gradients_match_jax(monkeypatch, compact):
    """d sum(out^2) / d (params, tokens) through K2 + K4's plain versions
    against jax.grad through the Pallas kernels; compaction on at 512
    tokens in both packages (COMPACT_MIN_TOKENS lowered to 256)."""
    if compact:
        monkeypatch.setattr(jfa, "COMPACT_MIN_TOKENS", 256)
        monkeypatch.setattr(tfa, "COMPACT_MIN_TOKENS", 256)
    rng = np.random.default_rng(5)
    jp = ja.attention_init(jax.random.key(5), 64)
    tokens = rng.standard_normal((2, 512, 64)).astype(np.float32)
    mask = rng.integers(0, 2, (2, 512)).astype(bool)

    def jloss(p, t):
        return jnp.sum(jnp.square(jfa.masked_attention_flash(
            p, t, jnp.asarray(mask))))

    jgp, jgt = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(tokens))
    tp = {k: v.requires_grad_() for k, v in _port_params(jp).items()}
    tt = torch.from_numpy(tokens).requires_grad_()
    out = tfa.masked_attention_flash(tp, tt, torch.from_numpy(mask))
    out.square().sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt),
                               atol=5e-4, rtol=5e-4)
    want = _port_params(jgp)
    for key, g in want.items():
        np.testing.assert_allclose(tp[key].grad.numpy(), g.numpy(),
                                   atol=5e-4, rtol=5e-4, err_msg=key)


def test_flash_mha_bias_takes_no_gradient():
    q, k, v = (torch.randn(1, 16, 64, requires_grad=True) for _ in range(3))
    bias = torch.zeros(1, 1, 16, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        tfa.flash_mha(q, k, v, bias, 1.0)
