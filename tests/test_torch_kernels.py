"""The flash kernels' wrappers (maskunet_tpu_torch.ops.flash_kernels).

This file imports neither jax nor the JAX package, so the card-only tests
run on a machine with the card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On the CPU a tensor goes to the kernel's plain version; on the card each
wrapper launches its CUDA kernel (K1 `flash_fwd_nomax`, K2
`flash_fwd_nomax_lse`, K4 `flash_bwd`), counted in `<wrapper>.launches`.
Kernel vs plain version, both bounds scaled to the plain output (as
chip_smoke.py holds them): max|diff| <= TOL max|plain| and rms(diff) <=
RMS_TOL rms(plain); f32 2e-5 / 1e-5 (summation order, the hardware exp2,
dQ's atomics adding in another order each run), bf16 2^-6 / 2^-7 (a value
rounded to bf16 on either side of a tie differs by one step, <= 2^-7 of
it). A kernel that skipped a key or query tile fails the rms bound.

pyproject's `error::DeprecationWarning:maskunet_tpu` filter also matches
`maskunet_tpu_torch` (unanchored regex): the port avoids deprecated torch
calls instead of editing the filter.
"""

import pytest
import torch

from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.ops import flash_kernels as tk


TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _inputs(c, dtype, device, lq=70, lk=45, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, n, c, generator=g).to(device, dtype)
               for n in (lq, lk, lk))
    mask = torch.rand(2, lk, generator=g) < 0.5
    return q, k, v, tfa.mask_to_bias(mask, 2, lk).to(device)


def _agrees(got: torch.Tensor, want: torch.Tensor) -> None:
    """Kernel output vs plain version, bounds of the module docstring."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    w = want.float()[fin]
    d = got.float()[fin] - w
    assert float(d.abs().max()) <= TOL[want.dtype] * float(w.abs().max())
    assert (float(d.square().mean().sqrt())
            <= RMS_TOL[want.dtype] * float(w.square().mean().sqrt()))


def test_cpu_tensor_runs_plain_version():
    q, k, v, bias = _inputs(64, torch.float32, "cpu")
    before = tk.flash_fwd_nomax.launches
    got = tk.flash_fwd_nomax(q, k, v, bias, 0.125, True)
    want = tk.flash_fwd_nomax_reference(q, k, v, bias, 0.125, True)
    assert torch.equal(got, want)
    assert tk.flash_fwd_nomax.launches == before


def test_kernel_wrapper_never_falls_back():
    """Off the CPU the wrapper launches its kernel or raises: a tensor on
    another device is refused, not computed by the plain version."""
    q = torch.empty(1, 8, 64, device="meta")
    before = tk.flash_fwd_nomax.launches
    with pytest.raises(ValueError, match="no flash kernel"):
        tk.flash_fwd_nomax(q, q, q, torch.empty(1, 1, 8, device="meta"), 1.0)
    assert tk.flash_fwd_nomax.launches == before


def test_training_wrappers_on_cpu_run_plain_versions():
    """K2 and K4 send CPU tensors to their plain versions, no launch."""
    q, k, v, bias = _inputs(64, torch.float32, "cpu")
    counts = (tk.flash_fwd_nomax_lse.launches, tk.flash_bwd.launches)
    o, lse = tk.flash_fwd_nomax_lse(q, k, v, bias, 0.125, True)
    want_o, want_lse = tk.flash_fwd_nomax_reference(q, k, v, bias, 0.125,
                                                    True, with_lse=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    do = torch.randn_like(q)
    got = tk.flash_bwd(q, k, v, bias, o, lse, do, 0.125, True)
    want = tk.flash_bwd_reference(q, k, v, bias, o, lse, do, 0.125, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tk.flash_fwd_nomax_lse.launches, tk.flash_bwd.launches) == counts


def test_training_wrappers_never_fall_back():
    q = torch.empty(1, 8, 64, device="meta")
    bias = torch.empty(1, 1, 8, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    counts = (tk.flash_fwd_nomax_lse.launches, tk.flash_bwd.launches)
    with pytest.raises(ValueError, match="no flash kernel"):
        tk.flash_fwd_nomax_lse(q, q, q, bias, 1.0)
    with pytest.raises(ValueError, match="no flash kernel"):
        tk.flash_bwd(q, q, q, bias, q, lse, q, 1.0)
    assert (tk.flash_fwd_nomax_lse.launches, tk.flash_bwd.launches) == counts


def test_bwd_ab_variants_apply_to_the_kernel_source():
    """Every K4 variant of the A/B tool is one substitution of the
    committed source away, so the tool measures what it names."""
    from maskunet_tpu_torch.tools import bwd_ab
    src = tk.SOURCES["flash_bwd"].read_text()
    texts = bwd_ab.variants(src)
    assert texts["source"] == src
    assert len(set(texts.values())) == len(texts)
    assert "atomicAdd(reinterpret_cast<float2*>" not in texts["scalar_atomics"]
    with pytest.raises(ValueError, match="no longer holds"):
        bwd_ab.variants(src.replace(bwd_ab._BQ, ""))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", tk.KERNEL_CHANNELS)
def test_kernel_matches_plain_version_on_card(cuda, c):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = _inputs(c, dtype, cuda, seed=c)
        for use_valid in (True, False):
            before = tk.flash_fwd_nomax.launches
            got = tk.flash_fwd_nomax(q, k, v, bias, c ** -0.5, use_valid)
            torch.cuda.synchronize()
            assert tk.flash_fwd_nomax.launches == before + 1
            _agrees(got, tk.flash_fwd_nomax_reference(
                q, k, v, bias, c ** -0.5, use_valid))


@pytest.mark.cuda
@pytest.mark.parametrize("c", tk.KERNEL_CHANNELS)
def test_lse_kernel_matches_plain_version_on_card(cuda, c):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = _inputs(c, dtype, cuda, seed=c + 1)
        bias[1] = tfa.NEG_INF                  # a fully-masked batch row
        for use_valid in (True, False):
            before = tk.flash_fwd_nomax_lse.launches
            o, lse = tk.flash_fwd_nomax_lse(q, k, v, bias, c ** -0.5,
                                            use_valid)
            torch.cuda.synchronize()
            assert tk.flash_fwd_nomax_lse.launches == before + 1
            want_o, want_lse = tk.flash_fwd_nomax_reference(
                q, k, v, bias, c ** -0.5, use_valid, with_lse=True)
            _agrees(o, want_o)
            _agrees(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("c", tk.KERNEL_CHANNELS)
def test_backward_kernel_matches_plain_version_on_card(cuda, c):
    """K4 against its plain version on the plain forward's o and lse; a
    fully-masked row's dQ is exactly 0, a NaN-poisoned K row gives NaN."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = _inputs(c, dtype, cuda, lq=200, lk=150, seed=c + 2)
        do = torch.randn_like(q)
        for use_valid, poison in ((True, False), (False, True)):
            b = bias.clone()
            kk = k.clone()
            if poison:
                kk[1, 3] = float("nan")
            else:
                b[1] = tfa.NEG_INF
            o, lse = tk.flash_fwd_nomax_reference(q, kk, v, b, c ** -0.5,
                                                  use_valid, with_lse=True)
            before = tk.flash_bwd.launches
            got = tk.flash_bwd(q, kk, v, b, o, lse, do, c ** -0.5, use_valid)
            torch.cuda.synchronize()
            assert tk.flash_bwd.launches == before + 1
            want = tk.flash_bwd_reference(q, kk, v, b, o, lse, do,
                                          c ** -0.5, use_valid)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                _agrees(g, w)
            if poison:
                assert torch.isnan(got[0][1]).all()
            else:
                assert bool((got[0][1] == 0).all())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, bias = _inputs(64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="channels"):
        tk.flash_fwd_nomax(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), bias, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tk.flash_fwd_nomax(q.transpose(0, 1).contiguous().transpose(0, 1),
                           k, v, bias, 1.0)
    with pytest.raises(TypeError, match="share one dtype"):
        tk.flash_fwd_nomax(q, k.float(), v, bias, 1.0)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tk.flash_fwd_nomax(shifted[1:].view(q.shape), k, v, bias, 1.0)
    o, lse = tk.flash_fwd_nomax_lse(q, k, v, bias, 1.0)
    with pytest.raises(ValueError, match="lse must be"):
        tk.flash_bwd(q, k, v, bias, o, lse[:, :, :-1], o, 1.0)
    with pytest.raises(ValueError, match="do must be"):
        tk.flash_bwd(q, k, v, bias, o, lse, o.float(), 1.0)
