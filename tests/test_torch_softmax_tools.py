"""The softmax A/B tools' kernels: the port's plain versions against the JAX
tools' Pallas kernels.

K5 `old_flash_fwd` and K6 `nomax65_fwd` (D with the clamp, E without) of
`maskunet_tpu_torch.tools.softmax_ab` against tools/softmax_ab.py, and K7
`flash_fwd_bf16` of `maskunet_tpu_torch.tools.bf16_softmax_experiment`
against tools/bf16_softmax_experiment.py. The JAX tools are imported by
path; K5 and K6 call `pl.pallas_call` without `interpret`, so it is
monkeypatched to `functools.partial(pl.pallas_call, interpret=True)` for
the call (K7 passes `interpret` itself). Same numpy inputs into both, batch
2, 256 queries x 512 keys, C 64.

Tolerances: f32 results 1e-5 of max|JAX| (summation order only); bf16
max|diff| <= 2^-6 max|JAX| and rms(diff) <= 2^-7 rms(JAX) (a value rounded
to bf16 on either side of a tie differs by one step, 2^-8 relative).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu_torch.core.layers import weak_scalar
from maskunet_tpu_torch.tools import bf16_softmax_experiment as tbf
from maskunet_tpu_torch.tools import softmax_ab as tsab

from test_torch_flash_bwd import _both, _close

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    """A tools/ script imported by path (tools/ is not a package)."""
    path = os.path.join(_ROOT, "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return _load_tool("softmax_ab"), _load_tool("bf16_softmax_experiment")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, *, masked_row=False):
    """q (scaled as the tools scale it), k, v and the bias, batch 2, 256
    queries, 512 keys, C 64; `masked_row` masks all of batch row 1's keys
    and half of row 0's."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((2, 256, 64)) * 0.35).astype(np.float32)
    k, v = (rng.standard_normal((2, 512, 64)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((2, 512), bool)
    if masked_row:
        mask[0] = rng.integers(0, 2, 512).astype(bool)
        mask[1] = False
    bias = np.where(mask[:, None, :], 0.0, -1e30).astype(np.float32)
    return q, k, v, bias


def _mean_v_rows(tv):
    return tv[1].float().mean(dim=0).expand(256, 64).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked_row", [False, True])
def test_old_fwd_plain_matches_jax(jax_tools, interpret, masked_row, dtype):
    """K5: natural exp, online max, no q scale, no use_valid; a fully
    masked row gives the mean of V. lse = m + ln(l) is the row's
    logsumexp."""
    q, k, v, bias = _inputs(1, masked_row=masked_row)
    (jq, jk, jv), (tq, tk_, tv) = _both((q, k, v), dtype)
    want = jax_tools[0].old_flash_fwd(jq, jk, jv, jnp.asarray(bias))
    o, lse = tsab.old_flash_fwd_reference(tq, tk_, tv, torch.from_numpy(bias))
    _close(o, want, dtype)
    s = torch.einsum("qc,kc->qk", tq[0].float(), tk_[0].float()) \
        + torch.from_numpy(bias[0])
    np.testing.assert_allclose(lse[0, 0].numpy(),
                               torch.logsumexp(s, dim=-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    if masked_row:
        _close(o[1], _mean_v_rows(tv), dtype)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("masked_row", [False, True])
def test_nomax65_plain_matches_jax(jax_tools, interpret, masked_row, clamp):
    """K6, variants D (clamp) and E: the bias rides in channel 65; a fully
    masked row gives 0. q65 and k65 are built as the JAX tool builds them,
    bit for bit."""
    q, k, v, bias = _inputs(2, masked_row=masked_row)
    (jq, jk, jv), (tq, tk_, tv) = _both((q, k, v), "bfloat16")
    tq65, tk65 = tsab.bias_as_channel(tq, tk_, torch.from_numpy(bias))
    jq65 = jnp.concatenate([jq * 1.4426950408889634,
                            jnp.ones((2, 256, 1), jnp.bfloat16)], axis=-1)
    jk65 = jnp.concatenate(
        [jk, jnp.asarray(bias).transpose(0, 2, 1).astype(jnp.bfloat16)],
        axis=-1)
    np.testing.assert_array_equal(tq65.float().numpy(),
                                  np.asarray(jq65.astype(jnp.float32)))
    np.testing.assert_array_equal(tk65.float().numpy(),
                                  np.asarray(jk65.astype(jnp.float32)))
    want = jax_tools[0].nomax65_fwd(jq65, jk65, jv, clamp=clamp)
    got = tsab.nomax65_fwd_reference(tq65, tk65, tv, clamp)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 64)
    _close(got, want, "bfloat16")
    if masked_row:
        assert torch.equal(got[1], torch.zeros_like(got[1]))


def test_nomax65_clamp_changes_large_scores():
    """Scores past 60: D saturates them, E does not (and stays finite
    while 2^s fits f32)."""
    q65 = torch.zeros(1, 4, 65, dtype=torch.bfloat16)
    q65[..., 64] = 1.0
    k65 = torch.zeros(1, 8, 65, dtype=torch.bfloat16)
    k65[0, :, 64] = torch.tensor([70.0, 64.0, 0, 0, 0, 0, 0, 0])
    v = torch.eye(8, 64, dtype=torch.bfloat16)[None]
    d = tsab.nomax65_fwd_reference(q65, k65, v, clamp=True)
    e = tsab.nomax65_fwd_reference(q65, k65, v, clamp=False)
    assert float(d[0, 0, 0]) == pytest.approx(0.5, abs=2 ** -8)
    assert float(e[0, 0, 0]) == pytest.approx(64 / 65, abs=2 ** -7)


@pytest.mark.parametrize("masked_row", [False, True])
def test_bf16_scores_plain_matches_jax(jax_tools, masked_row):
    """K7: bf16 scores, running max and p; o and lse against the JAX
    experiment's kernel, tiled as that kernel tiles the keys; a fully
    masked row gives the mean of V."""
    q, k, v, bias = _inputs(3, masked_row=masked_row)
    (jq, jk, jv), (tq, tk_, tv) = _both((q, k, v), "bfloat16")
    want_o, want_lse = jax_tools[1].flash_fwd_bf16(jq, jk, jv,
                                                   jnp.asarray(bias))
    block_k = jfa._block_sizes(256, 512, jnp.bfloat16)[1]
    o, lse = tbf.flash_fwd_bf16_reference(tq, tk_, tv,
                                          torch.from_numpy(bias), block_k)
    _close(o, want_o, "bfloat16")
    # lse = f32(m) + ln(l), l the f32 sum of the bf16 p. XLA on the CPU
    # folds the kernel's bf16 round trip of p into that sum (measured: its
    # l is the sum of the unrounded p), the port rounds as the kernel says;
    # each p's rounding is at most 2^-9 of it, so |d lse| <= ln(1 + 2^-9).
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(want_lse)[0],
                               atol=np.log1p(2.0 ** -9), rtol=0)
    if masked_row:
        _close(o[1], _mean_v_rows(tv), "bfloat16")
        bf_neg = float(torch.tensor(-1e30, dtype=torch.bfloat16))
        np.testing.assert_allclose(lse[1].numpy(), bf_neg, rtol=1e-6)


def test_bf16_scores_reference_follows_the_tile_recurrence():
    """The plain K7's closed form over key tiles (running max by cummax,
    each tile carried by the product of the later tiles' alpha) against the
    kernel's recurrence written tile by tile, with a ragged last tile, a
    fully masked row and a running max that rises over the tiles."""
    q, k, v, bias = _inputs(4, masked_row=True)
    tq, tk_, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tk_[0, 200:] *= 3                        # the max moves in later tiles
    tb = torch.from_numpy(bias)
    o, lse = tbf.flash_fwd_bf16_reference(tq, tk_, tv, tb, block_k=96)
    for i in range(2):
        m = torch.full((256, 1), -1e30).bfloat16()
        l, acc = torch.zeros(256, 1), torch.zeros(256, 64)
        for t0 in range(0, 512, 96):
            s = (tq[i].float() @ tk_[i, t0:t0 + 96].float().T).bfloat16() \
                + tb[i, :, t0:t0 + 96].bfloat16()
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp((m - m_new).float())
            l = alpha * l + p.float().sum(-1, keepdim=True)
            acc = alpha * acc + p.float() @ tv[i, t0:t0 + 96].float()
            m = m_new
        l = l.clamp(min=1e-30)
        _close(o[i], (acc / l).bfloat16().float().numpy(), "bfloat16")
        np.testing.assert_allclose(lse[i, 0].numpy(),
                                   (m.float() + l.log())[:, 0].numpy(),
                                   rtol=1e-6)


def test_tool_inputs_follow_the_jax_tools():
    """The tools' q scaling rounds the constant to bf16 first, as JAX's
    weak typing does with `q * 0.35`."""
    q, k, v, bias = tsab.attn6_inputs(1, device="cpu")
    assert q.shape == (1, 16384, 64) and k.shape == (1, 9216, 64)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    assert torch.equal(bias, torch.zeros(1, 1, 9216))
    assert weak_scalar(0.35, torch.bfloat16) == 0.349609375
