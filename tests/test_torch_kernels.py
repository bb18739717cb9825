"""The flash kernels' wrappers (maskunet_tpu_torch.ops.flash_kernels).

This file imports neither jax nor the JAX package, so the card-only tests
run on a machine with the card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On the CPU a tensor goes to the kernel's plain version; on the card each
wrapper launches its CUDA kernel (K1 `flash_fwd_nomax`, K2
`flash_fwd_nomax_lse`, K3 `flash_fwd_online`, K4 `flash_bwd` with and
without its clamp, and the A/B tools' K5 `softmax_ab.old_flash_fwd`, K6
`softmax_ab.nomax65_fwd` with its repack kernel `softmax_ab.repack65`,
and K7 `bf16_softmax_experiment.flash_fwd_bf16`), counted in
`<wrapper>.launches`. K1-K7 have edge cases where their TMA boxes meet
ragged lengths.
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

import ctypes
import re
import subprocess

import numpy as np
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


def _k6_inputs(b, lq, lk, seed=0, nan_row=True):
    """q65, k65 [B, L, 65] and v [B, Lk, 64], bf16 on the CPU, drawn with
    numpy, with a general 65th channel: random, 0 on every 5th query row
    and negated on every 3rd. qa = 40 on batch row 0's first 4 queries
    meets kb = 2 on every 9th key: scores near 80, past the clamp at 60
    (|qa kb| stays below ~100 elsewhere, so that exp2 stays finite without
    the clamp). `nan_row`: a NaN in key 3 of batch row 1."""
    rng = np.random.default_rng(seed)
    q65, k65 = (rng.standard_normal((b, n, 65)).astype(np.float32)
                for n in (lq, lk))
    q65[..., :64] *= 0.35
    q65[:, ::5, 64] = 0.0
    q65[:, 1::3, 64] *= -1.0
    q65[0, :4, 64] = 40.0
    k65[..., 64] *= 0.5
    k65[0, ::9, 64] = 2.0
    if nan_row:
        k65[1, 3] = np.nan
    v = rng.standard_normal((b, lk, 64)).astype(np.float32)
    return tuple(torch.from_numpy(a).bfloat16() for a in (q65, k65, v))


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
        (tsab.repack65, lambda: tsab.repack65(k65),
         lambda: tsab.repack65_reference(k65)),
    ]


@pytest.mark.parametrize("which", range(5))
def test_new_wrappers_on_cpu_run_plain_versions(which):
    """K3, K5, K6, K7 and K6's repack send CPU tensors to their plain
    versions, with no launch counted; so does K4 with clamp=False."""
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


@pytest.mark.parametrize("which", range(5))
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
    for bad in (q65.float(), q65[..., :64]):
        with pytest.raises(ValueError, match="repack65 takes"):
            tsab.repack65(bad)


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


def test_fwd_ab_variants_apply_to_the_kernel_source():
    """Every K1/K2 variant of the forward A/B tool is one substitution of
    the committed source away: the mma.sync body at every C or at C 256,
    thread 0 as the producer, ping-pong at C 64 and none at C 128, a ring
    of two or three stages, 64 or 256 keys a step, three consumer
    warpgroups, 128 keys a step at C 128, K6 without ping-pong, K6's E
    without its cap at 128."""
    from maskunet_tpu_torch.tools import fwd_ab
    src = tk.SOURCES["flash_fwd_nomax"].read_text()
    texts = fwd_ab.variants(src)
    assert set(texts) == {"source", "mma_sync", "c256_mma_sync",
                          "producer0", "pingpong", "c128_no_pingpong",
                          "stages2", "stages3", "keys64", "keys256",
                          "wg3", "c128_keys128", "k6_no_pingpong",
                          "k6e_uncapped"}
    assert texts["source"] == src
    assert len(set(texts.values())) == len(texts)
    for name, line in (("mma_sync", "{ return false; }"),
                       ("c256_mma_sync", "{ return c == 64 || c == 128; }"),
                       ("producer0", "kProducerWarp = false;"),
                       ("pingpong", "kPingPong64 = true;"),
                       ("c128_no_pingpong", "kPingPong128 = false;"),
                       ("stages2", "kStages64 = 2;"),
                       ("stages3", "kStages64 = 3;"),
                       ("keys64", "kKeys64 = 64;"),
                       ("keys256", "kKeys64 = 256;"),
                       ("keys256", "kStages64 = 2;"),
                       ("wg3", "kConsumers = 3;"),
                       ("c128_keys128", "kKeys128 = 128;"),
                       ("k6_no_pingpong", "kPingPongK6 = false;"),
                       ("k6e_uncapped", ": s);")):
        assert line in texts[name] and line not in src
    for name, old in (("mma_sync", fwd_ab._WGMMA_C),
                      ("c256_mma_sync", fwd_ab._WGMMA_C),
                      ("producer0", fwd_ab._PRODUCER),
                      ("pingpong", fwd_ab._PINGPONG),
                      ("c128_no_pingpong", fwd_ab._PINGPONG128),
                      ("stages2", fwd_ab._STAGES),
                      ("stages3", fwd_ab._STAGES),
                      ("keys64", fwd_ab._KEYS), ("keys256", fwd_ab._KEYS),
                      ("wg3", fwd_ab._WGS),
                      ("c128_keys128", fwd_ab._KEYS128),
                      ("c128_keys128", fwd_ab._STAGES128),
                      ("k6_no_pingpong", fwd_ab._PINGPONG_K6),
                      ("k6e_uncapped", fwd_ab._E_CAP)):
        assert old not in texts[name]
        with pytest.raises(ValueError, match="no longer holds"):
            fwd_ab.variants(src.replace(old, ""))


def test_forward_body_channels_match_the_kernel_source():
    """The wrapper's list of the forward's wgmma channels is the source's
    own."""
    src = tk.SOURCES["flash_fwd_nomax"].read_text()
    want = " || ".join(f"c == {c}" for c in tk.FWD_WGMMA_CHANNELS)
    assert f"constexpr bool wgmma_body(int c) {{ return {want}; }}" in src
    assert 'extern "C" int flash_fwd_nomax_body(int c)' in src


def test_online_ab_variants_apply_to_the_kernel_source():
    """Every K3/K7 variant of the forward A/B tool's `--source online` is
    one substitution of the committed online source away: the mma.sync
    body at every C, thread 0 as the producer, no ping-pong at C 64 or
    128, a three-stage ring, 64 keys a step at C 64."""
    from maskunet_tpu_torch.tools import fwd_ab
    src = tk.SOURCES["flash_fwd_online"].read_text()
    texts = fwd_ab.variants(src, fwd_ab.ONLINE_VARIANTS)
    assert set(texts) == {"source", "mma_sync", "producer0",
                          "c64_no_pingpong", "c128_no_pingpong", "stages3",
                          "keys64", "k5_expf"}
    assert texts["source"] == src
    assert len(set(texts.values())) == len(texts)
    for name, line in (("mma_sync", "{ return false; }"),
                       ("producer0", "kProducerWarp = false;"),
                       ("c64_no_pingpong", "kPingPong64 = false;"),
                       ("c128_no_pingpong", "kPingPong128 = false;"),
                       ("stages3", "kStages64 = 3;"),
                       ("keys64", "kKeys64 = 64;"),
                       ("k5_expf", "kExpByFma = false;")):
        assert line in texts[name] and line not in src
    for old in (fwd_ab._WGMMA_C, fwd_ab._PRODUCER, fwd_ab._PINGPONG64_ON,
                fwd_ab._PINGPONG128, fwd_ab._STAGES, fwd_ab._KEYS,
                fwd_ab._EXP_BY_FMA):
        with pytest.raises(ValueError, match="no longer holds"):
            fwd_ab.variants(src.replace(old, ""), fwd_ab.ONLINE_VARIANTS)


def test_online_body_channels_match_the_kernel_source():
    """The wrapper's list of K3's wgmma channels is the online source's
    own, and the source exports the body query the wrapper binds."""
    src = tk.SOURCES["flash_fwd_online"].read_text()
    want = " || ".join(f"c == {c}" for c in tk.ONLINE_WGMMA_CHANNELS)
    assert f"constexpr bool wgmma_body(int c) {{ return {want}; }}" in src
    assert 'extern "C" int flash_fwd_online_body(int c)' in src
    assert tk._ENTRIES["flash_fwd_online_body"][0] == "flash_fwd_online"
    assert tk.flash_fwd_online_body(64, torch.float32) == "fma"


def test_k5_runs_the_online_wgmma_body():
    """K5's entry runs the online wgmma body, as K3 and K7 do, at any key
    count above 0 (the mma.sync body is left only for a call with no
    key), and the body's natural exponential is the FMA form or __expf
    by one switch, which tools/fwd_ab.py's `k5_expf` flips."""
    src = tk.SOURCES["flash_fwd_online"].read_text()
    entry = src[src.index('extern "C" int flash_fwd_online_exp('):]
    entry = entry[:entry.index("\n}\n")]
    assert "run_bf16<64, kNatural, false>(" in entry
    run_bf16 = src[src.index("cudaError_t run_bf16(const Args& a) {"):]
    run_bf16 = run_bf16[:run_bf16.index("\n}\n")]
    assert ("  if constexpr (wgmma_body(C)) {\n"
            "    if (a.lk > 0) return run_wgmma<C, MODE, UV>(a);\n  }"
            in run_bf16)
    assert "kNatural" not in run_bf16
    assert 64 in tk.ONLINE_WGMMA_CHANNELS
    assert src.count("constexpr bool kExpByFma = true;") == 1
    assert "MODE == kNatural && kExpByFma" in src


def test_k6_runs_the_forward_wgmma_body_after_its_repack():
    """K6 is a mode of the no-max source's wgmma body fed by its repack
    kernel, both entries of that library: no source of its own."""
    src = tk.SOURCES["flash_fwd_nomax"].read_text()
    assert set(tk.SOURCES) == {"flash_fwd_nomax", "flash_fwd_online",
                               "flash_bwd"}
    assert all(p.exists() for p in tk.SOURCES.values())
    assert not (tk.SOURCES["flash_fwd_nomax"].parent
                / "flash_fwd_nomax65.cu").exists()
    for entry in ("flash_fwd_nomax65", "flash_repack65"):
        assert tk._ENTRIES[entry][0] == "flash_fwd_nomax"
        assert f'extern "C" int {entry}(' in src
    entry = src[src.index('extern "C" int flash_fwd_nomax65('):]
    entry = entry[:entry.index("\n}\n")]
    assert "run_wgmma<64, false, kChannel>(" in entry
    assert "run_wgmma<64, false, kChannelNoClamp>(" in entry


def test_bf16_tool_block_k_is_the_kernel_key_step():
    """K7's result depends on its key tile, so the plain version's
    BLOCK_K is the key step of K7's kernel: `kKeys64` of the online
    source, the C = 64 step of both of its bf16 bodies."""
    src = tk.SOURCES["flash_fwd_online"].read_text()
    steps = re.findall(r"constexpr int kKeys64 = (\d+);", src)
    assert steps == [str(tbf.BLOCK_K)]
    assert "C == 64 ? kKeys64" in src                    # the wgmma body
    assert "MODE == kBf16Scores ? kKeys64" in src        # the mma.sync body


def _recorded_launches(monkeypatch) -> list:
    """Takes every tensor for the card and records each launch's (entry,
    arguments) instead of launching."""
    calls = []
    monkeypatch.setattr(tk, "_on_card", lambda t: True)
    monkeypatch.setattr(tk, "_launch",
                        lambda name, device, *args: calls.append((name, args)))
    return calls


def _chunk_check(calls, name, tensors, n_ptrs, b, rows):
    """One launch of `name` a chunk of at most `rows` batch rows: its first
    pointers those of `tensors` at the chunk's first row, and after all
    `n_ptrs` pointers (the wrapper's outputs and scratch too) the chunk's
    row count."""
    starts = range(0, b, rows)
    assert [c[0] for c in calls] == [name] * len(starts)
    for (_, args), i in zip(calls, starts):
        assert list(args[:len(tensors)]) == [
            t.data_ptr() + i * t[0].numel() * t.element_size()
            for t in tensors]
        assert args[n_ptrs] == min(rows, b - i)


@pytest.mark.parametrize("shape", [(65536, 8, 8), (2, 2 ** 30, 8),
                                   (4096, 2 ** 20, 8)])
def test_backward_wrapper_refuses_what_its_launch_cannot_take(shape,
                                                             monkeypatch):
    """K4 past what one launch takes: more batch rows than a grid's y
    dimension (65,535) go in chunks of 65,528 rows, and for the wgmma body
    in chunks whose B * Lq stays below 2^31 (2,040 rows at Lq = 2^20);
    where not even 8 rows fit (Lq >= 2^28) it raises ValueError before
    anything is launched or computed."""
    b, lq, lk = shape
    q = torch.empty(b, lq, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, lk, 64, dtype=torch.bfloat16, device="meta")
    bias = torch.empty(b, 1, lk, device="meta")
    lse = torch.empty(b, 1, lq, device="meta")
    calls = _recorded_launches(monkeypatch)
    before = tk.flash_bwd.launches
    if lq >= 2 ** 28:
        with pytest.raises(ValueError, match="flash_bwd"):
            tk.flash_bwd(q, k, k, bias, q, lse, q, 1.0)
        assert calls == [] and tk.flash_bwd.launches == before
        return
    tk.flash_bwd(q, k, k, bias, q, lse, q, 1.0)
    rows = 65528 if b * lq < 2 ** 31 else (2 ** 31 - 1) // lq // 8 * 8
    assert rows == (65528 if lq == 8 else 2040)
    # (q, k, v, bias, do, lse, then the wrapper's delta, dq, dk, dv)
    _chunk_check(calls, "flash_bwd", (q, k, k, bias, q, lse), 10, b, rows)
    assert tk.flash_bwd.launches == before + len(calls)


def _forward_wrapper_calls(b):
    """(counter holder, entry, call, batch-leading inputs, pointers a
    launch takes) of each forward wrapper on meta tensors of `b` batch
    rows."""
    q, k = (torch.empty(b, 8, 64, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    bias = torch.empty(b, 1, 8, device="meta")
    q65 = torch.empty(b, 8, 65, dtype=torch.bfloat16, device="meta")
    # K6's workspace as the wrapper allocates it (q64, qa, k64, kb), then v:
    # meta tensors all start at 0, so these give the chunks' offsets
    ws = (q, torch.empty(b, 8, device="meta"), q,
          torch.empty(b, 8, device="meta"), k)
    return [
        (tk.flash_fwd_nomax, "flash_fwd_nomax",
         lambda: tk.flash_fwd_nomax(q, k, k, bias, 1.0), (q, k, k, bias), 5),
        (tk.flash_fwd_nomax_lse, "flash_fwd_nomax_lse",
         lambda: tk.flash_fwd_nomax_lse(q, k, k, bias, 1.0), (q, k, k, bias),
         6),
        (tk.flash_fwd_online, "flash_fwd_online",
         lambda: tk.flash_fwd_online(q, k, k, bias, 1.0), (q, k, k, bias),
         6),
        (tsab.old_flash_fwd, "flash_fwd_online_exp",
         lambda: tsab.old_flash_fwd(q, k, k, bias), (q, k, k, bias), 6),
        (tsab.nomax65_fwd, "flash_fwd_nomax65",
         lambda: tsab.nomax65_fwd(q65, q65, k), ws, 6),
        (tbf.flash_fwd_bf16, "flash_fwd_online_bf16",
         lambda: tbf.flash_fwd_bf16(q, k, k, bias), (q, k, k, bias), 6),
    ]


@pytest.mark.parametrize("which", range(6))
def test_forward_wrappers_launch_in_batch_chunks(which, monkeypatch):
    """K1, K2, K3, K5, K6 and K7 launch 65,536 batch rows as two launches,
    of 65,528 and 8 rows (a grid's y dimension stops at 65,535), each with
    the inputs' pointers at its first row; every launch is counted. K6
    first repacks q65 and k65 whole, one launch each (a 1-D grid over
    rows), then launches its kernel in chunks on the workspace."""
    calls = _recorded_launches(monkeypatch)
    wrapper, name, call, inputs, n_ptrs = _forward_wrapper_calls(65536)[which]
    before = wrapper.launches
    repacks = tsab.repack65.launches
    call()
    if name == "flash_fwd_nomax65":
        assert [c[0] for c in calls[:2]] == ["flash_repack65"] * 2
        assert [c[1][3:] for c in calls[:2]] == [(65536, 8)] * 2
        assert tsab.repack65.launches == repacks + 2
        calls = calls[2:]
    _chunk_check(calls, name, inputs, n_ptrs, 65536, 65528)
    assert [c[1][n_ptrs] for c in calls] == [65528, 8]
    assert wrapper.launches == before + 2


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
def test_kernels_past_65535_batch_rows_on_card(cuda):
    """65,536 batch rows (small L, bf16, C 64: the wgmma bodies): K1, K2
    and K4 launch twice, in chunks of 65,528 and 8 rows, and agree with
    their plain versions on every row."""
    b, lq, lk = 65536, 20, 24
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(b, n, 64, generator=g).to(cuda, torch.bfloat16)
                   for n in (lq, lk, lk, lq))
    bias = tfa.mask_to_bias(torch.rand(b, lk, generator=g) < 0.5, b,
                            lk).to(cuda)
    counts = (tk.flash_fwd_nomax.launches, tk.flash_fwd_nomax_lse.launches,
              tk.flash_bwd.launches)
    o1 = tk.flash_fwd_nomax(q, k, v, bias, 0.125, True)
    o, lse = tk.flash_fwd_nomax_lse(q, k, v, bias, 0.125, True)
    got = tk.flash_bwd(q, k, v, bias, o, lse, do, 0.125, True)
    torch.cuda.synchronize()
    assert (tk.flash_fwd_nomax.launches, tk.flash_fwd_nomax_lse.launches,
            tk.flash_bwd.launches) == tuple(n + 2 for n in counts)
    want_o, want_lse = tk.flash_fwd_nomax_reference(q, k, v, bias, 0.125,
                                                    True, with_lse=True)
    _agrees(o1, want_o)
    _agrees(o, want_o)
    _agrees(lse, want_lse)
    want = tk.flash_bwd_reference(q, k, v, bias, o, lse, do, 0.125, True)
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
@pytest.mark.parametrize("c", tk.ONLINE_WGMMA_CHANNELS)
@pytest.mark.parametrize("edge", [(3, 200, 150), (3, 37, 200), (3, 50, 700),
                                  (3, 129, 129), (3, 37, 129)])
def test_online_kernel_at_ragged_edges_on_card(cuda, c, edge):
    """K3's bf16 wgmma body where its TMA boxes meet the edges of Lq (past
    or below the 128-query block), Lk (past the key step) and the batch,
    use_valid both ways; batch row 1 then fully masked: lse -1e30, o 0
    with use_valid and the mean of the visible slots' V without."""
    b, lq, lk = edge
    g = torch.Generator().manual_seed(lq + lk + c)
    q, k, v = (torch.randn(b, n, c, generator=g).to(cuda, torch.bfloat16)
               for n in (lq, lk, lk))
    bias = tfa.mask_to_bias(torch.rand(b, lk, generator=g) < 0.5, b,
                            lk).to(cuda)
    masked = bias.clone()
    masked[1] = tfa.NEG_INF
    for bb, use_valid in ((bias, True), (bias, False), (masked, True),
                          (masked, False)):
        o, lse = tk.flash_fwd_online(q, k, v, bb, c ** -0.5, use_valid)
        torch.cuda.synchronize()
        want_o, want_lse = tk.flash_fwd_online_reference(q, k, v, bb,
                                                         c ** -0.5, use_valid)
        _agrees(o, want_o)
        _agrees(lse, want_lse)
        if bb is masked:
            assert bool((lse[1] == float(torch.tensor(tfa.NEG_INF))).all())
            mean_v = v[1].float().mean(0).expand(lq, c).bfloat16()
            if use_valid:
                assert bool((o[1] == 0).all())
            else:
                _agrees(o[1], mean_v)


@pytest.mark.cuda
def test_bf16_tool_kernel_at_ragged_shape_on_card(cuda):
    """K7 where its key tile meets a ragged Lk (one past the tile, and
    several tiles with a ragged last one), against its plain version at
    the kernel's BLOCK_K; batch row 1 fully masked gives the mean of V."""
    g = torch.Generator().manual_seed(11)
    for lq, lk in ((37, tbf.BLOCK_K + 1), (150, 3 * tbf.BLOCK_K + 50)):
        q = (torch.randn(2, lq, 64, generator=g) * 0.125).to(cuda,
                                                            torch.bfloat16)
        k, v = (torch.randn(2, lk, 64, generator=g).to(cuda, torch.bfloat16)
                for _ in range(2))
        bias = tfa.mask_to_bias(torch.rand(2, lk, generator=g) < 0.5, 2,
                                lk).to(cuda)
        bias[1] = tfa.NEG_INF
        before = tbf.flash_fwd_bf16.launches
        o, lse = tbf.flash_fwd_bf16(q, k, v, bias)
        torch.cuda.synchronize()
        assert tbf.flash_fwd_bf16.launches == before + 1
        want_o, want_lse = tbf.flash_fwd_bf16_reference(q, k, v, bias,
                                                        tbf.BLOCK_K)
        _agrees(o, want_o)
        _agrees(lse, want_lse)
        _agrees(o[1], v[1].float().mean(0).expand(lq, 64).bfloat16())


# every bf16 input through CUDA's h2exp and the online source's
# exp_bf16x2 (K7's exponential), the source included whole
_EXP_CHECK = r"""
#include "@SOURCE@"

__global__ void exp_pair(unsigned short* by_h2exp, unsigned short* ours) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const __nv_bfloat16 x = __ushort_as_bfloat16((unsigned short)i);
  const __nv_bfloat162 x2 = __halves2bfloat162(x, x);
  by_h2exp[i] = __bfloat16_as_ushort(__low2bfloat16(h2exp(x2)));
  ours[i] = __bfloat16_as_ushort(__float2bfloat16_rn(exp_bf16x2(x2).x));
}

extern "C" int exp_check(void* by_h2exp, void* ours) {
  exp_pair<<<256, 256>>>((unsigned short*)by_h2exp, (unsigned short*)ours);
  return int(cudaDeviceSynchronize());
}
"""


# the no-max source's ex2 at and past 128, the source included whole
_EX2_CHECK = r"""
#include "@SOURCE@"

__global__ void ex2_of(const float* x, float* y, int n) {
  if (int(threadIdx.x) < n) y[threadIdx.x] = ex2(x[threadIdx.x]);
}

extern "C" int ex2_check(const float* x, float* y, int n) {
  ex2_of<<<1, 32>>>(x, y, n);
  return int(cudaDeviceSynchronize());
}
"""


@pytest.mark.cuda
def test_ex2_is_inf_from_128_on_card(cuda, tmp_path):
    """K6's E clamps its exp2 argument at 128 (`kExp2Inf`), which leaves
    exp2 as it is only if the kernels' ex2 gives +inf from 128 on, as
    exp2 in f32 does."""
    src = tmp_path / "ex2_check.cu"
    src.write_text(_EX2_CHECK.replace(
        "@SOURCE@", str(tk.SOURCES["flash_fwd_nomax"])))
    lib = tmp_path / "ex2_check.so"
    subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    x = torch.tensor([127.0, 127.99, 128.0, 128.5, 200.0, 1e30,
                      float("inf"), float("nan")], device=cuda)
    y = torch.empty_like(x)
    assert ctypes.CDLL(str(lib)).ex2_check(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        ctypes.c_int(x.numel())) == 0
    y = y.cpu()
    assert bool(torch.isfinite(y[:2]).all())
    assert bool((y[2:7] == float("inf")).all()) and bool(torch.isnan(y[7]))
    assert bool(torch.isinf(torch.exp2(x[2:7].cpu())).all())


@pytest.mark.cuda
def test_bf16_exp_is_h2exp_but_for_subnormals_on_card(cuda, tmp_path):
    """K7's exponential (`exp_bf16x2`, h2exp's arithmetic with ex2's
    flush-to-zero form) gives h2exp's bits on all 65,536 bf16 inputs (NaN
    for NaN), except where h2exp returns a bf16 subnormal (p < 2^-126),
    which it gives as 0."""
    src = tmp_path / "exp_check.cu"
    src.write_text(_EXP_CHECK.replace(
        "@SOURCE@", str(tk.SOURCES["flash_fwd_online"])))
    lib = tmp_path / "exp_check.so"
    subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    by_h2exp, ours = (torch.empty(65536, dtype=torch.int16, device=cuda)
                      for _ in range(2))
    assert ctypes.CDLL(str(lib)).exp_check(
        ctypes.c_void_p(by_h2exp.data_ptr()),
        ctypes.c_void_p(ours.data_ptr())) == 0
    h = by_h2exp.view(torch.bfloat16).float().cpu()
    f = ours.view(torch.bfloat16).float().cpu()
    differ = (by_h2exp != ours).cpu() & ~(torch.isnan(h) & torch.isnan(f))
    assert bool((h[differ].abs() < 2.0 ** -126).all())
    assert bool((f[differ] == 0).all())


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
    """K5, K6 (D and E), K7 and K6's repack at a ragged shape with a fully
    masked batch row (the mean of V for K5 and K7, 0 for K6)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [(3, 37, 129), (3, 150, 434), (3, 200, 150)])
def test_k5_at_ragged_shapes_on_card(cuda, edge):
    """K5 on the online wgmma body where Lq stops short of its 128-query
    block and Lk of its 128-key tile: against its plain version; batch row
    1 fully masked gives the mean of V (lse -1e30), a NaN in a key row of
    batch row 2 gives NaN."""
    b, lq, lk = edge
    g = torch.Generator().manual_seed(lq + lk)
    q = (torch.randn(b, lq, 64, generator=g) * 0.125).to(cuda, torch.bfloat16)
    k, v = (torch.randn(b, lk, 64, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    bias = tfa.mask_to_bias(torch.rand(b, lk, generator=g) < 0.5, b,
                            lk).to(cuda)
    bias[1] = tfa.NEG_INF
    k[2, 5] = float("nan")
    before = tsab.old_flash_fwd.launches
    o, lse = tsab.old_flash_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert tsab.old_flash_fwd.launches == before + 1
    want_o, want_lse = tsab.old_flash_fwd_reference(q, k, v, bias)
    _agrees(o, want_o)
    _agrees(lse[0], want_lse[0])
    _agrees(o[1], v[1].float().mean(0).expand(lq, 64).bfloat16())
    assert bool((lse[1] == float(torch.tensor(tfa.NEG_INF))).all())
    assert torch.isnan(o[2]).all() and torch.isnan(lse[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lk", [129, 131])
def test_k6_at_ragged_shapes_on_card(cuda, lk):
    """K6 D and E (its repack, then the wgmma body's K6 mode) at Lq 37 and
    Lk 129 / 131 (k65's rows off any 16-byte boundary; the keys past Lk in
    the last tile zeroed whatever qa is) with `_k6_inputs`' general 65th
    channel: against the plain version, NaN on the poisoned batch row, D
    and E apart where scores pass 60; the repack exact."""
    q65, k65, v = (t.to(cuda) for t in _k6_inputs(2, 37, lk, seed=lk))
    outs = {}
    for clamp in (True, False):
        counts = (tsab.nomax65_fwd.launches, tsab.repack65.launches)
        o = tsab.nomax65_fwd(q65, k65, v, clamp)
        torch.cuda.synchronize()
        assert (tsab.nomax65_fwd.launches, tsab.repack65.launches) == (
            counts[0] + 1, counts[1] + 2)
        _agrees(o, tsab.nomax65_fwd_reference(q65, k65, v, clamp))
        assert torch.isnan(o[1]).all() and torch.isfinite(o[0]).all()
        outs[clamp] = o
    assert not torch.equal(outs[True][0, :4], outs[False][0, :4])
    got, want = tsab.repack65(k65), tsab.repack65_reference(k65)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
