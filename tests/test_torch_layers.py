"""The port's layers (maskunet_tpu_torch.core.layers) against the JAX ones.

Inputs come from a numpy seed and go through both packages on the CPU.
f32 tolerances are f32 noise (different summation orders: 1e-5 relative);
bf16 cases are held to two bf16 steps of the output magnitude (bf16 keeps
8 bits: one step is 2^-7 relative), since XLA and torch round bf16
intermediates at different places.

pyproject's `error::DeprecationWarning:maskunet_tpu` filter is an
unanchored module regex, so it also covers `maskunet_tpu_torch`: the port
keeps clear of deprecated torch calls rather than editing the filter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.core import layers as jl
from maskunet_tpu_torch.core import initializers as ti
from maskunet_tpu_torch.core import layers as tl

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16_close(got: torch.Tensor, want, steps: float = 2.0):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = steps * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("ksize,bias", [(3, False), (3, True), (1, True)])
def test_conv2d(rng, ksize, bias):
    x = _np(rng, 2, 8, 8, 5)
    w = _np(rng, ksize, ksize, 5, 7)              # HWIO
    b = _np(rng, 7) if bias else None
    p = {"kernel": jnp.asarray(w)}
    if bias:
        p["bias"] = jnp.asarray(b)
    want = jl.conv2d(p, jnp.asarray(x))
    got = tl.conv2d(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    None if b is None else torch.from_numpy(b),
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_linear(rng):
    x, w, b = _np(rng, 2, 10, 6), _np(rng, 6, 4), _np(rng, 4)
    want = jl.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x))
    got = tl.linear(torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_batchnorm_eval(rng):
    x = _np(rng, 2, 4, 4, 6)
    scale, offset, mean = _np(rng, 6), _np(rng, 6), _np(rng, 6)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    want, _ = jl.batchnorm({"scale": scale, "offset": offset},
                           {"mean": mean, "var": var}, jnp.asarray(x),
                           train=False)
    got = tl.batchnorm(*(torch.from_numpy(a) for a in
                         (scale, offset, mean, var, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_layernorm_channels_and_joint(rng):
    x = _np(rng, 2, 4, 4, 6) * 3 + 1
    # attention norm: over C
    s, o = _np(rng, 6), _np(rng, 6)
    want = jl.layernorm({"scale": s, "offset": o}, jnp.asarray(x))
    got = tl.layernorm(torch.from_numpy(s), torch.from_numpy(o),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the model's joint final norm: JAX keeps (H, W, C), the port the
    # reference's [C, H, W] and permutes it at the call
    s, o = _np(rng, 4, 4, 6), _np(rng, 4, 4, 6)
    want = jl.layernorm({"scale": s, "offset": o}, jnp.asarray(x))
    s_chw = torch.from_numpy(s.transpose(2, 0, 1).copy())
    o_chw = torch.from_numpy(o.transpose(2, 0, 1).copy())
    got = tl.layernorm(s_chw.permute(1, 2, 0), o_chw.permute(1, 2, 0),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gelu_f32_exact_and_bf16_tanh(rng):
    x = _np(rng, 4096) * 3
    np.testing.assert_allclose(tl.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu(jnp.asarray(x))), **F32)
    xb = torch.from_numpy(x).bfloat16()
    want = jl.gelu(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    got = tl.gelu(xb)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want, steps=1.0)
    # the bf16 path is the tanh form, not erf: it must differ from exact
    # erf-GELU somewhere at f32 precision
    tanh_f32 = torch.nn.functional.gelu(xb.float(), approximate="tanh")
    np.testing.assert_allclose(tl.gelu(xb.float()).numpy(),
                               torch.nn.functional.gelu(xb.float()).numpy())
    assert (tanh_f32 - torch.nn.functional.gelu(xb.float())).abs().max() > 0


def test_max_pool_2x(rng):
    x = _np(rng, 2, 8, 6, 3)
    np.testing.assert_array_equal(tl.max_pool_2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.max_pool_2x(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_align_corners(rng, dtype):
    x = _np(rng, 2, 4, 5, 3)
    if dtype == "float32":
        want = jl.upsample_2x_bilinear(jnp.asarray(x))
        got = tl.upsample_2x_bilinear(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        # align_corners=True: the same map as torch's own bilinear resize
        ref = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
            mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)
    else:
        xb = torch.from_numpy(x).bfloat16()
        want = jl.upsample_2x_bilinear(
            jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
        got = tl.upsample_2x_bilinear(xb)
        assert got.dtype == torch.bfloat16
        _bf16_close(got, want)


def test_interp_matrix_is_own_copy():
    for n_in, n_out in ((1, 2), (4, 8), (5, 10)):
        np.testing.assert_array_equal(tl._interp_matrix_np(n_in, n_out),
                                      jl._interp_matrix_np(n_in, n_out))


def test_weak_scalar_rounds_like_jax(rng):
    x = torch.from_numpy(_np(rng, 1000)).bfloat16()
    c = 1.4426950408889634
    want = np.asarray(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                      * c).astype(np.float32)
    got = (x * tl.weak_scalar(c, torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_initializers_bounds():
    g = torch.Generator().manual_seed(0)
    w = ti.conv_kernel(g, 3, 3, 16, 32)
    assert w.shape == (32, 16, 3, 3)
    bound = 1 / (16 * 9) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    lw = ti.linear_kernel(g, 64, 8)
    assert lw.shape == (8, 64) and float(lw.abs().max()) <= 1 / 8
    # same seed, same numbers
    a = ti.torch_uniform(torch.Generator().manual_seed(3), (5,), 4)
    b = ti.torch_uniform(torch.Generator().manual_seed(3), (5,), 4)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 4, 4, 6), (1, 2, 2, 3)])
def test_batchnorm_train_and_running_stats(rng, shape):
    """Batch statistics, biased variance to normalise, unbiased variance
    into the running stats (momentum 0.1), all in f32: 1e-5."""
    x = _np(rng, *shape) * 3.0 + 1.0
    c = shape[-1]
    scale, offset, mean = _np(rng, c), _np(rng, c), _np(rng, c)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    want, new = jl.batchnorm({"scale": scale, "offset": offset},
                             {"mean": mean, "var": var}, jnp.asarray(x),
                             train=True)
    got, new_mean, new_var = tl.batchnorm_train(
        *(torch.from_numpy(a) for a in (scale, offset, mean, var, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(new["mean"]),
                               **F32)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(new["var"]),
                               **F32)
    assert not new_mean.requires_grad and not new_var.requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_with_injected_keep_mask_equals_jax(rng, dtype):
    """The same keep mask gives the same output, bit for bit; in bf16 the
    divisor 1 - 0.3 is rounded to bf16 first (0.69921875), as JAX's weak
    typing does."""
    x = _np(rng, 2, 4, 4, 8)
    keep = rng.random(x.shape) >= 0.3
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jl.dropout(jnp.asarray(x).astype(jdt), rate=0.3, rng=None,
                      train=True, keep_mask=jnp.asarray(keep))
    got = tl.dropout(torch.from_numpy(x).to(tdt), rate=0.3, generator=None,
                     train=True, keep_mask=torch.from_numpy(keep))
    assert got.dtype == tdt
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert tl.dropout(torch.from_numpy(x), rate=0.3, generator=None,
                      train=False) is not None


def test_dropout_keep_mask_draw():
    g = torch.Generator().manual_seed(0)
    keep = tl.dropout_keep_mask(g, 0.3, (4, 64, 64))
    assert keep.dtype == torch.bool and 0.68 < keep.float().mean() < 0.72
    x = torch.ones(4, 64, 64)
    assert torch.equal(tl.dropout(x, rate=0.3, generator=None, train=False),
                       x)
    y = tl.dropout(x, rate=0.3, generator=torch.Generator().manual_seed(0),
                   train=True)
    assert torch.equal(y != 0, keep)
