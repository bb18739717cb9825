"""The flash kernels' wrappers (maskunet_tpu_torch.ops.flash_kernels).

This file imports neither jax nor the JAX package, so the card-only tests
run on a machine with the card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On the CPU a tensor goes to the kernel's plain version; on the card each
wrapper launches its CUDA kernel (K1 `flash_fwd_nomax`, K2
`flash_fwd_nomax_lse`, K3 `flash_fwd_online`, K4 `flash_bwd` with and
without its clamp, and the A/B tools' K5 `softmax_ab.old_flash_fwd`, K6
`softmax_ab.nomax65_fwd` and K7 `bf16_softmax_experiment.flash_fwd_bf16`),
counted in `<wrapper>.launches`.
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
from maskunet_tpu_torch.tools import bf16_softmax_experiment as tbf
from maskunet_tpu_torch.tools import softmax_ab as tsab


TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _inputs(c, dtype, device, lq=70, lk=45, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, n, c, generator=g).to(device, dtype)
               for n in (lq, lk, lk))
    mask = torch.rand(2, lk, generator=g) < 0.5
    return q, k, v, tfa.mask_to_bias(mask, 2, lk).to(device)


def _above_clamp_inputs(c, dtype, device, lq=200, lk=150, seed=0):
    """Base-2 scores far past the clamp at 60 on batch row 0's first 8
    queries, computed exactly: integer q and k in [-4, 4] (q x 6 on those
    rows) and a scale whose q multiplier scale * log2e is 1/8, so every
    score is a multiple of 1/64 far inside f32's 24 bits whatever the
    summation order. Random scores that large would carry f32 summation
    noise of ~1e-4 into exp2(s - lse), past the f32 bound. Returns (q, k,
    v, bias, scale)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-4, 5, (2, lq, c), generator=g).float()
    q[0, :8] *= 6
    k = torch.randint(-4, 5, (2, lk, c), generator=g).float()
    v = torch.randn(2, lk, c, generator=g)
    mask = torch.rand(2, lk, generator=g) < 0.5
    bias = tfa.mask_to_bias(mask, 2, lk)
    return (*(t.to(device, dtype) for t in (q, k, v)), bias.to(device),
            0.125 / tk._LOG2E)


def test_above_clamp_inputs_give_exact_scores_past_60():
    """The inputs of the unclamped-backward checks: scores past 60, the
    same in any summation order, and the clamp changes the plain K4."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias, scale = _above_clamp_inputs(64, dtype, "cpu")
        qs = q * tk.weak_scalar(scale * tk._LOG2E, dtype)
        assert tk.weak_scalar(scale * tk._LOG2E, dtype) == 0.125
        s = qs[0].double() @ k[0].double().T
        assert torch.equal(s.float().double(), s)
        assert torch.equal(torch.flip(qs[0].float(), [1])
                           @ torch.flip(k[0].float(), [1]).T, s.float())
        o, lse = tk.flash_fwd_online_reference(q, k, v, bias, scale, True)
        assert float(lse.max()) > 60.0
        do = torch.randn_like(q)
        free, clamped = (tk.flash_bwd_reference(q, k, v, bias, o, lse, do,
                                                scale, True, clamp=cl)
                         for cl in (False, True))
        assert all(torch.isfinite(g).all() for g in free)
        assert not torch.allclose(free[0].float(), clamped[0].float())


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


def _tool_inputs(device, lq=150, lk=90, seed=0):
    """bf16 q, k, v at C 64, a random mask with batch row 1 fully masked,
    and q65 / k65 of the same (the tools' kernels' only instantiation)."""
    q, k, v, bias = _inputs(64, torch.bfloat16, "cpu", lq=lq, lk=lk,
                            seed=seed)
    bias[1] = tfa.NEG_INF
    q65, k65 = tsab.bias_as_channel(q, k, bias)
    return [t.to(device) for t in (q, k, v, bias, q65, k65)]


def _new_wrapper_calls(q, k, v, bias, q65, k65):
    """(counted wrapper, call, plain version's call) of the wrappers this
    slice added."""
    return [
        (tk.flash_fwd_online, lambda: tk.flash_fwd_online(q, k, v, bias,
                                                          0.125, True),
         lambda: tk.flash_fwd_online_reference(q, k, v, bias, 0.125, True)),
        (tsab.old_flash_fwd, lambda: tsab.old_flash_fwd(q, k, v, bias),
         lambda: tsab.old_flash_fwd_reference(q, k, v, bias)),
        (tsab.nomax65_fwd, lambda: tsab.nomax65_fwd(q65, k65, v, False),
         lambda: tsab.nomax65_fwd_reference(q65, k65, v, False)),
        (tbf.flash_fwd_bf16, lambda: tbf.flash_fwd_bf16(q, k, v, bias),
         lambda: tbf.flash_fwd_bf16_reference(q, k, v, bias)),
    ]


@pytest.mark.parametrize("which", range(4))
def test_new_wrappers_on_cpu_run_plain_versions(which):
    """K3, K5, K6 and K7 send CPU tensors to their plain versions, with no
    launch counted; so does K4 with clamp=False."""
    wrapper, call, plain = _new_wrapper_calls(*_tool_inputs("cpu"))[which]
    before = wrapper.launches
    got, want = call(), plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert wrapper.launches == before
    if which == 0:
        q, k, v, bias = _inputs(64, torch.float32, "cpu")
        o, lse = tk.flash_fwd_online(q, k, v, bias, 0.125, True)
        do = torch.randn_like(q)
        count = tk.flash_bwd.launches
        got = tk.flash_bwd(q, k, v, bias, o, lse, do, 0.125, True, clamp=False)
        want = tk.flash_bwd_reference(q, k, v, bias, o, lse, do, 0.125, True,
                                      clamp=False)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert tk.flash_bwd.launches == count


@pytest.mark.parametrize("which", range(4))
def test_new_wrappers_off_the_cpu_launch_or_raise(which, monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused, and a tensor taken for the card goes to the
    launch, whose failure (here: no library) raises instead of falling
    back to the plain version."""
    meta = _tool_inputs("meta")
    wrapper, call, _ = _new_wrapper_calls(*meta)[which]
    before = wrapper.launches
    with pytest.raises(ValueError, match="no flash kernel"):
        call()
    wrapper, call, _ = _new_wrapper_calls(*_tool_inputs("cpu"))[which]
    monkeypatch.setattr(tk, "_on_card", lambda t: True)

    def no_library(name, *args):
        raise RuntimeError(f"no kernel library for {name}")

    monkeypatch.setattr(tk, "_launch", no_library)
    with pytest.raises(RuntimeError, match="no kernel library"):
        call()
    assert wrapper.launches == before


def test_tool_wrappers_take_bf16_at_c64_only():
    q, k, v, bias, q65, k65 = _tool_inputs("cpu")
    for fn in (tsab.old_flash_fwd, tbf.flash_fwd_bf16):
        with pytest.raises(ValueError, match="bf16 at C = 64 only"):
            fn(q.float(), k.float(), v.float(), bias)
        with pytest.raises(ValueError, match="bf16 at C = 64 only"):
            fn(*(torch.cat([t, t], -1) for t in (q, k, v)), bias)
    with pytest.raises(ValueError, match="bf16 at C = 64 only"):
        tsab.nomax65_fwd(q65.float(), k65.float(), v.float())
    with pytest.raises(ValueError, match="needs q65"):
        tsab.nomax65_fwd(q65[..., :64], k65[..., :64], v)


def test_bwd_ab_variants_apply_to_the_kernel_source():
    """Every K4 variant of the A/B tool is one substitution of the
    committed source away, so the tool measures what it names: the
    mma.sync body at C 64, dQ by atomics, a shallower ring, one or two
    warpgroups a block."""
    from maskunet_tpu_torch.tools import bwd_ab
    src = tk.SOURCES["flash_bwd"].read_text()
    texts = bwd_ab.variants(src)
    assert set(texts) == {"source", "mma_sync", "atomics", "stages2", "wg1",
                          "wg2"}
    assert texts["source"] == src
    assert len(set(texts.values())) == len(texts)
    assert "tma_reduce_add_3d(tdq" in src
    assert (texts["atomics"].count("atomicAdd(")
            == src.count("atomicAdd(") + 2)
    assert "tma_reduce_add_3d(tdq" not in texts["atomics"]
    assert "return false;" in texts["mma_sync"]
    for name, old in (("stages2", bwd_ab._STAGES), ("wg1", bwd_ab._WGS),
                      ("wg2", bwd_ab._WGS)):
        assert old not in texts[name]
        with pytest.raises(ValueError, match="no longer holds"):
            bwd_ab.variants(src.replace(old, ""))


def test_backward_body_channels_match_the_kernel_source():
    """The wrapper's list of wgmma channels is the source's own."""
    src = tk.SOURCES["flash_bwd"].read_text()
    want = " || ".join(f"c == {c}" for c in tk.BWD_WGMMA_CHANNELS)
    assert f"constexpr bool wgmma_body(int c) {{ return {want}; }}" in src


@pytest.mark.parametrize("shape", [(65536, 8, 8), (2, 2 ** 30, 8)])
def test_backward_wrapper_refuses_what_its_launch_cannot_take(shape,
                                                             monkeypatch):
    """A tensor taken for the card whose shape the launch cannot take (a
    grid of more than 65,535 batch rows; for the wgmma body, B * Lq past
    int32) raises ValueError before anything is launched or computed."""
    b, lq, lk = shape
    q = torch.empty(b, lq, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, lk, 64, dtype=torch.bfloat16, device="meta")
    bias = torch.empty(b, 1, lk, device="meta")
    lse = torch.empty(b, 1, lq, device="meta")
    monkeypatch.setattr(tk, "_on_card", lambda t: True)

    def no_launch(name, *args):
        raise AssertionError(f"{name} launched")

    monkeypatch.setattr(tk, "_launch", no_launch)
    before = tk.flash_bwd.launches
    with pytest.raises(ValueError, match="flash_bwd"):
        tk.flash_bwd(q, k, k, bias, q, lse, q, 1.0)
    assert tk.flash_bwd.launches == before


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


# (batch, Lq, Lk) where K4's tiles meet ragged edges: Lq past a multiple
# of the 64-query step or below it, Lk past a multiple of the key tile
# (192 keys at C 64, 128 at C 128) or below it
_BWD_EDGES = [(3, 200, 150), (3, 37, 200), (3, 50, 700), (2, 1000, 300),
              (3, 64, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("edge", _BWD_EDGES)
def test_backward_kernel_at_ragged_edges_on_card(cuda, c, edge):
    """K4 against its plain version where its TMA boxes and dQ reduction
    meet the edges of Lq, Lk and the batch; clamped and not, both dtypes."""
    b, lq, lk = edge
    g = torch.Generator().manual_seed(lq + lk)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, n, c, generator=g).to(cuda, dtype)
                       for n in (lq, lk, lk, lq))
        bias = tfa.mask_to_bias(torch.rand(b, lk, generator=g) < 0.5, b,
                                lk).to(cuda)
        for use_valid, clamp in ((True, True), (False, False)):
            fwd = (tk.flash_fwd_nomax_reference if clamp
                   else tk.flash_fwd_online_reference)
            o, lse = fwd(q, k, v, bias, c ** -0.5, use_valid,
                         **({"with_lse": True} if clamp else {}))
            got = tk.flash_bwd(q, k, v, bias, o, lse, do, c ** -0.5,
                               use_valid, clamp=clamp)
            torch.cuda.synchronize()
            want = tk.flash_bwd_reference(q, k, v, bias, o, lse, do,
                                          c ** -0.5, use_valid, clamp=clamp)
            for gt, w in zip(got, want):
                _agrees(gt, w)


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


@pytest.mark.cuda
@pytest.mark.parametrize("c", tk.KERNEL_CHANNELS)
def test_online_kernel_matches_plain_version_on_card(cuda, c):
    """K3: o and lse against the plain version, both dtypes, use_valid
    both ways; batch row 1 fully masked (o 0 with use_valid, the mean of V
    without; lse -1e30), then a NaN-poisoned K row (NaN)."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = _inputs(c, dtype, cuda, seed=c + 3)
        for use_valid, row1 in ((True, None), (False, None),
                                (True, "masked"), (False, "masked"),
                                (False, "nan")):
            b, kk = bias.clone(), k.clone()
            if row1 == "masked":
                b[1] = tfa.NEG_INF
            elif row1 == "nan":
                kk[1, 5] = float("nan")
            before = tk.flash_fwd_online.launches
            o, lse = tk.flash_fwd_online(q, kk, v, b, c ** -0.5, use_valid)
            torch.cuda.synchronize()
            assert tk.flash_fwd_online.launches == before + 1
            want_o, want_lse = tk.flash_fwd_online_reference(
                q, kk, v, b, c ** -0.5, use_valid)
            _agrees(o, want_o)
            _agrees(lse[0], want_lse[0])
            if row1 == "masked":
                assert bool((lse[1] == float(torch.tensor(tfa.NEG_INF))).all())
                if use_valid:
                    assert bool((o[1] == 0).all())
                else:
                    _agrees(o[1], want_o[1])
            elif row1 == "nan":
                assert torch.isnan(o[1]).all() and torch.isnan(lse[1]).all()
            else:
                _agrees(lse[1], want_lse[1])


@pytest.mark.cuda
@pytest.mark.parametrize("c", tk.KERNEL_CHANNELS)
def test_backward_without_clamp_matches_plain_version_on_card(cuda, c):
    """K4 with clamp=False on K3's plain o and lse; with scores past 60
    on some rows the clamped backward differs and the unclamped one
    stays finite."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias, scale = _above_clamp_inputs(c, dtype, cuda)
        do = torch.randn_like(q)
        for use_valid in (True, False):
            o, lse = tk.flash_fwd_online_reference(q, k, v, bias, scale,
                                                   use_valid)
            assert float(lse.max()) > 60.0
            before = tk.flash_bwd.launches
            got = tk.flash_bwd(q, k, v, bias, o, lse, do, scale, use_valid,
                               clamp=False)
            torch.cuda.synchronize()
            assert tk.flash_bwd.launches == before + 1
            want = tk.flash_bwd_reference(q, k, v, bias, o, lse, do, scale,
                                          use_valid, clamp=False)
            for g, w in zip(got, want):
                assert torch.isfinite(g).all()
                _agrees(g, w)
            clamped = tk.flash_bwd(q, k, v, bias, o, lse, do, scale,
                                   use_valid)
            assert not torch.allclose(clamped[0].float(), got[0].float())


@pytest.mark.cuda
def test_tool_kernels_match_plain_versions_on_card(cuda):
    """K5, K6 (D and E) and K7 at a ragged shape with a fully masked
    batch row (the mean of V for K5 and K7, 0 for K6)."""
    q, k, v, bias, q65, k65 = _tool_inputs(cuda, lq=150, lk=90)
    calls = _new_wrapper_calls(q, k, v, bias, q65, k65)[1:]
    calls.append((tsab.nomax65_fwd,
                  lambda: tsab.nomax65_fwd(q65, k65, v, True),
                  lambda: tsab.nomax65_fwd_reference(q65, k65, v, True)))
    for wrapper, call, plain in calls:
        before = wrapper.launches
        got, want = call(), plain()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        got, want = (got, want) if isinstance(got, tuple) else ((got,),
                                                              (want,))
        _agrees(got[0], want[0])
        if wrapper is tsab.nomax65_fwd:
            assert bool((got[0][1] == 0).all())
        else:
            _agrees(got[1][0], want[1][0])
