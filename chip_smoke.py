#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what it computes.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure exits non-zero and prints no
final result):

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, the build of the kernel libraries from
   maskunet_tpu_torch/csrc (seconds, ptxas registers and spills; those of
   K4's wgmma instantiations named, and 0 spill bytes required), and the
   body K4 runs in bf16 at each C (wgmma or mma_sync).
2. kernel: K1 `flash_fwd_nomax` against its plain PyTorch version at the
   six serving attention shapes (batch 8, 128x128 images) in bf16 and f32,
   plus a ragged shape, a fully-masked row (must give 0) and a NaN-poisoned
   K row (must give NaN).
3. kernel_lse, kernel_bwd: K2 `flash_fwd_nomax_lse` (o and lse) and K4
   `flash_bwd` (dq, dk, dv) against their plain versions at the same
   shapes and cases, both dtypes; K4 also, at each C its wgmma body takes,
   at shapes whose Lq is no multiple of the 64-query step (or below it)
   and whose Lk is no multiple of the key tile, batch 2-3: the edges of
   its TMA maps and dQ reduction.
4. serving: `serve.build_model_runner` on the ADE model (c_out 150, 128x128,
   batch 8, bf16, random weights from the recipe seed) behind the serving
   micro-batcher; 16 requests from 4 threads, each answer equal to a direct
   runner call; the kernel must launch 6 times per forward; the model's
   logits on the kernel agree with the logits on its plain version.
5. serving times: the serving forward (ms per batch, img/s), a device
   profile of it, and per attention shape K1, its plain version, the
   PyTorch library call computing the same function (timed only) and the
   bound.
6. train: the ADE training step (c_out 150, 128x128, batch 8, bf16, recipe
   seed 42, AdamW lr 5e-5 and weight decay 0.1, the recipe's cached masks
   with precomputed plans) on a fixed synthetic batch: one step launches
   K2 and K4 6 times each and K1 never, one eval step launches K1 6 times,
   the gradients through the kernels agree with those through their plain
   versions (f32: cosine >= 0.99 per tensor; bf16: the loss within 1%, and
   every tensor as close to the f32 gradient as the plain path's), and 10
   steps keep the loss finite and lower it.
7. train times: ms per step and img/s, a device profile of 3 steps, and per
   attention shape K2 and K4 against their plain versions, their bounds and
   the library's forward and backward (K4's lines name its body).
8. kernel_online, kernel_bwd_noclamp: K3 `flash_fwd_online` (o and lse)
   and K4 with `clamp=False` on K3's lse against their plain versions at
   the same shapes and cases, both dtypes, plus a fully-masked row without
   use_valid (K3 gives the mean of V) and exact scores far past the clamp
   at 60 (where K4 clamped and unclamped must differ), and K4's edge
   shapes.
9. safe_serving, safe_train: the same serving and training paths with the
   safe softmax on (`flash_attention._SAFE_SOFTMAX`, what
   MASKUNET_SAFE_SOFTMAX=1 sets): a forward launches K3 6 times and K1
   never; a training step launches K3 6 and K4 6 times (all unclamped),
   K1 and K2 never; an eval step K3 6 times; logits and gradients against
   the plain versions as in 4 and 6; 10 steps lower the loss; wall and
   device times of both.
10. online_time: K3 per attention shape against its plain version, its
    bound and the library.
11. tools: the A/B tools' K5 `softmax_ab.old_flash_fwd`, K6
    `softmax_ab.nomax65_fwd` (clamped and not) and K7
    `bf16_softmax_experiment.flash_fwd_bf16` against their plain versions
    at the tools' attn6 inputs, the three tool mains (the kernels' main
    path), then each kernel's time, plain time, bound and library time.

It imports torch, numpy and the port, nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from maskunet_tpu_torch import serve
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.ops import flash_attention as fa
from maskunet_tpu_torch.ops import flash_kernels as fk
from maskunet_tpu_torch.tasks import recipes
from maskunet_tpu_torch.tools import bf16_softmax_experiment as bf16_tool
from maskunet_tpu_torch.tools import softmax_ab
from maskunet_tpu_torch.train import loop as train_loop
from maskunet_tpu_torch.train import step as train_step

BATCH = 8
IMG = 128
NUM_CLASSES = 150
# (layer, Lq, Lk after compaction, C, use_valid) of the serving forward
SERVING_SHAPES = (
    ("attn1", 4096, 2560, 128, False),
    ("attn2", 1024, 1024, 256, True),
    ("attn3", 256, 256, 256, True),
    ("attn4", 1024, 1024, 128, True),
    ("attn5", 4096, 2560, 64, False),
    ("attn6", 16384, 9216, 64, False),
)
# kernel vs plain version, both scaled to the output itself (the serving
# shapes' outputs are far below 1, so no floor of 1):
#   max|diff| <= TOL * max|plain|      f32: f32 noise (other summation
#     order, ex2.approx vs exp2); bf16: the two round the f32 result to
#     bf16 on either side of a tie, one ulp <= 2^-7 |x|, so 2^-6 is twice
#     the worst single-entry rounding difference;
#   rms(diff) <= RMS_TOL * rms(plain)  catches a small error spread over
#     many entries (one skipped key tile of attn6's 144 moves O by ~8% rms).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s,
# dense bf16 tensor-core flop/s, f32 FMA flop/s; exp2 on the special
# function units: 16 results/clock/SM (CUDA C++ Programming Guide's
# arithmetic-instruction throughput table, cc 9.0) x 132 SMs x
# 1.98 GHz boost.
PEAK = {"bytes": 3.35e12, torch.bfloat16: 989e12, torch.float32: 67e12,
        "exp2": 16 * 132 * 1.98e9}
C65 = 65                     # K6's contraction: 64 channels and the bias
SERVE_LOGIT_TOL = 0.05       # x max|logit|, bf16 model, kernel vs plain
SERVE_ARGMAX_AGREE = 0.98
# Gradients of one step through the kernels vs through their plain
# versions (same weights, masks, dropout draws and batch). In f32 every
# tensor's cosine must reach TRAIN_GRAD_COS. In bf16 the two paths round
# p, dS and the activations to bf16 at different points, and that rounding
# alone leaves many tensors' bf16 gradients at cosine ~0.95 from the f32
# gradient in either path (measured on the card); so in bf16 the loss must
# agree within TRAIN_LOSS_RTOL and, for every tensor whose bf16 gradient
# carries signal (plain-path cosine to f32 >= BF16_SIGNAL_COS), the kernel
# path must be as close to the f32 gradient as the plain path, within
# BF16_COS_MARGIN.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_COS = 0.99
BF16_SIGNAL_COS = 0.9
BF16_COS_MARGIN = 0.02
TRAIN_STEPS = 10

failures: list[str] = []


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        failures.append(what)
        print(f"FAIL: {what}", file=sys.stderr, flush=True)


def device_ms(fn, iters: int, windows: int = 3) -> float:
    """Best-of-`windows` device time per call, by CUDA events. Each window's
    launches queue behind a spin on the stream, so the events bracket the
    device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e5) * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def attention_inputs(gen, lq, lk, c, use_valid, dtype):
    """q (pre-scaled by 1/sqrt(C), as the model calls the kernel), k, v
    and the bias of a Bernoulli(0.5) mask; compacted layers get the bias
    of the capacity buffer's valid slots."""
    dev = "cuda"
    q = (torch.randn(BATCH, lq, c, generator=gen, device=dev)
         * c ** -0.5).to(dtype)
    k = torch.randn(BATCH, lk, c, generator=gen, device=dev).to(dtype)
    v = torch.randn(BATCH, lk, c, generator=gen, device=dev).to(dtype)
    mask = torch.rand(BATCH, lq, generator=gen, device=dev) < 0.5
    if not use_valid:
        mask = fa.plan_compaction(mask).valid
    assert mask.shape[1] == lk
    return q, k, v, fa.mask_to_bias(mask, BATCH, lk)


def bound_ms(q, k, bias) -> tuple[float, float]:
    """Least time for this call's work: bytes moved once (q, k, v, bias
    in, o out) against the operations its data needs (products and exp2
    over the visible keys only)."""
    b, lq, c = q.shape
    visible = int((bias > fa.NEG_INF * 0.5).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + bias.numel() * 4
    t_bytes = nbytes / PEAK["bytes"]
    t_ops = max(4 * lq * visible * c / PEAK[q.dtype],
                lq * visible / PEAK["exp2"])
    return t_bytes * 1e3, t_ops * 1e3


def device_kernel_rows(prof) -> list:
    """(device us, name, calls) of the device kernels a profile saw,
    largest first. An operator's row repeats its kernels' time, and a user
    annotation on the device (e.g. `Optimizer.step#AdamW.step`) spans them,
    so only the kernels themselves count."""
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.is_user_annotation]
    return sorted(rows, reverse=True)


def wgmma_ptxas(log: str) -> list:
    """(function, stack/spill line, registers line) of each of K4's wgmma
    instantiations in ptxas's report."""
    lines = log.splitlines()
    return [[ln.strip().rsplit(" ", 1)[-1], lines[i + 1].strip(),
             lines[i + 2].strip()]
            for i, ln in enumerate(lines[:-2])
            if "Function properties" in ln and "bwd_wgmma" in ln]


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and bool(card), "nvidia-smi read the card")
    builds = fk.build()
    emit(phase="device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device_name=torch.cuda.get_device_name(0),
         builds={name: {"seconds": info["seconds"], "cached": info["cached"],
                        "ptxas": [ln.strip() for ln in info["log"].splitlines()
                                  if "registers" in ln or "spill" in ln]}
                 for name, info in builds.items()},
         libraries_with_spills=[
             name for name, info in builds.items()
             if any("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                    "loads" not in ln for ln in info["log"].splitlines())])
    k4 = wgmma_ptxas(builds["flash_bwd"]["log"])
    bodies = {c: fk.flash_bwd_body(c, torch.bfloat16)
              for c in fk.KERNEL_CHANNELS}
    emit(phase="device_k4", k4_bodies_bf16=bodies, wgmma_ptxas=k4)
    check(len(k4) == 4 * len(fk.BWD_WGMMA_CHANNELS) and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln for _, ln, _ in k4),
        f"K4's wgmma instantiations (4 a C) built without spills: {k4}")
    check(all((b == "wgmma") == (c in fk.BWD_WGMMA_CHANNELS)
              for c, b in bodies.items()),
          f"K4 runs wgmma at C in {fk.BWD_WGMMA_CHANNELS}: {bodies}")
    return card


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel output vs plain version over the plain version's finite
    entries, both bounds scaled to the plain output; NaN where it is NaN."""
    finite = torch.isfinite(want)
    plain = want.float()[finite]
    diff = got.float()[finite] - plain
    if plain.numel() == 0:
        err = rel_rms = 0.0
        tol = plain_rms = 1.0
    else:
        err = float(diff.abs().max())
        tol = TOL[want.dtype] * float(plain.abs().max())
        plain_rms = float(plain.square().mean().sqrt()) or 1.0
        rel_rms = float(diff.square().mean().sqrt()) / plain_rms
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    return {"max_abs_err": err, "tol": tol,
            "err_over_rms_plain": err / plain_rms,
            "rms_err_over_rms_plain": rel_rms, "rms_tol": RMS_TOL[want.dtype],
            "nan_match": same_nan,
            "ok": err <= tol and rel_rms <= RMS_TOL[want.dtype] and same_nan}


def kernel_cases(gen, dtype):
    """(name, q, k, v, bias, use_valid, row1) of the kernel checks: the six
    serving shapes, a ragged one, a fully-masked batch row 1 (row1
    'masked') and a NaN-poisoned K in batch row 1 (row1 'nan')."""
    for name, lq, lk, c, uv in SERVING_SHAPES:
        yield (name, *attention_inputs(gen, lq, lk, c, uv, dtype), uv, None)
    q, k, v = (torch.randn(2, 37, 64, generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    bias = fa.mask_to_bias(torch.rand(2, 37, generator=gen,
                                      device="cuda") < 0.5, 2, 37)
    yield "ragged37", q, k, v, bias, True, None
    masked = bias.clone()
    masked[1] = fa.NEG_INF
    yield "fully_masked_row", q, k, v, masked, True, "masked"
    poisoned = k.clone()
    poisoned[1] = float("nan")
    yield "nan_poisoned_k", q, poisoned, v, bias, False, "nan"


# (batch, Lq, Lk, use_valid) of K4's edge shapes: Lq past a multiple of
# the 64-query step or below it, Lk past a multiple of the key tile (192
# keys at C 64, 128 at C 128) or below it
BWD_EDGES = ((3, 200, 150, True), (3, 37, 200, False), (3, 50, 700, True),
             (2, 1000, 300, False), (3, 64, 40, True))


def bwd_edge_cases(gen, dtype):
    """`kernel_cases`' tuples for K4's edge shapes (BWD_EDGES) at each C
    whose bf16 backward runs the wgmma body."""
    for c in fk.BWD_WGMMA_CHANNELS:
        for b, lq, lk, uv in BWD_EDGES:
            q = (torch.randn(b, lq, c, generator=gen, device="cuda")
                 * c ** -0.5).to(dtype)
            k, v = (torch.randn(b, lk, c, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            bias = fa.mask_to_bias(torch.rand(b, lk, generator=gen,
                                              device="cuda") < 0.5, b, lk)
            yield f"edge_c{c}_b{b}_q{lq}_k{lk}", q, k, v, bias, uv, None


def row1_as_expected(out: torch.Tensor, row1) -> bool:
    """A fully-masked row gives exact zeros, a NaN-poisoned one NaN (and
    row 0 stays finite)."""
    if row1 == "masked":
        return bool((out[1] == 0).all())
    if row1 == "nan":
        return bool(torch.isnan(out[1]).all() and torch.isfinite(out[0]).all())
    return True


def emit_case(phase, name, q, k, use_valid, outputs) -> float:
    """One line per case; returns the case's worst absolute error."""
    ok = all(a["ok"] and a.get("expected", True) for a in outputs.values())
    emit(phase=phase, case=name, dtype=str(q.dtype).split(".")[-1],
         shape=[list(q.shape), list(k.shape)], use_valid=use_valid,
         outputs=outputs, ok=ok)
    check(ok, f"{phase} {name} {q.dtype}")
    return max(a["max_abs_err"] for a in outputs.values())


def phase_kernel() -> dict:
    """K1 vs its plain version; returns the worst absolute error."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias, uv, row1 in kernel_cases(gen, dtype):
            got = fk.flash_fwd_nomax(q, k, v, bias, 1.0, uv)
            torch.cuda.synchronize()
            a = agreement(got, fk.flash_fwd_nomax_reference(q, k, v, bias,
                                                            1.0, uv))
            a["expected"] = row1_as_expected(got, row1)
            worst = max(worst, emit_case("kernel", name, q, k, uv, {"o": a}))
    return {"max_abs_err": worst}


def phase_kernel_lse() -> dict:
    """K2 (o and lse) vs its plain version; returns the worst error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias, uv, row1 in kernel_cases(gen, dtype):
            o, lse = fk.flash_fwd_nomax_lse(q, k, v, bias, 1.0, uv)
            torch.cuda.synchronize()
            want_o, want_lse = fk.flash_fwd_nomax_reference(
                q, k, v, bias, 1.0, uv, with_lse=True)
            outs = {"o": agreement(o, want_o), "lse": agreement(lse, want_lse)}
            outs["o"]["expected"] = row1_as_expected(o, row1)
            worst = max(worst, emit_case("kernel_lse", name, q, k, uv, outs))
    return {"max_abs_err": worst}


def phase_kernel_bwd() -> dict:
    """K4 (dq, dk, dv) vs its plain version on the plain forward's o and
    lse and a random dO; returns the worst error."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias, uv, row1 in (*kernel_cases(gen, dtype),
                                              *bwd_edge_cases(gen, dtype)):
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            o, lse = fk.flash_fwd_nomax_reference(q, k, v, bias, 1.0, uv,
                                                  with_lse=True)
            got = fk.flash_bwd(q, k, v, bias, o, lse, do, 1.0, uv)
            torch.cuda.synchronize()
            want = fk.flash_bwd_reference(q, k, v, bias, o, lse, do, 1.0, uv)
            outs = {n: agreement(g, w)
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            outs["dq"]["expected"] = row1_as_expected(got[0], row1)
            if row1 == "nan":
                outs["dk"]["expected"] = bool(torch.isnan(got[1][1]).all())
            worst = max(worst, emit_case("kernel_bwd", name, q, k, uv, outs))
            del o, lse, got, want
    return {"max_abs_err": worst}


def above_clamp_inputs(gen, c, dtype):
    """Base-2 scores far past the clamp at 60 (up to ~100) on batch row 0's
    first 8 queries, computed exactly: integer q and k in [-4, 4] (x 6 on
    those rows) and scale = 1 / (8 log2 e), so q's multiplier is 1/8 and
    every score is a multiple of 1/64, the same in any summation order.
    Random scores that large carry ~1e-4 of f32 summation noise into
    exp2(s - lse), past the f32 bound. Returns (q, k, v, bias, scale)."""
    q = torch.randint(-4, 5, (2, 200, c), generator=gen, device="cuda")
    q[0, :8] *= 6
    k = torch.randint(-4, 5, (2, 150, c), generator=gen, device="cuda")
    v = torch.randn(2, 150, c, generator=gen, device="cuda")
    mask = torch.rand(2, 150, generator=gen, device="cuda") < 0.5
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            fa.mask_to_bias(mask, 2, 150), 0.125 / fk._LOG2E)


def online_cases(gen, dtype):
    """(name, q, k, v, bias, use_valid, row1, scale) of K3 and of K4
    without its clamp: `kernel_cases` at scale 1, a fully-masked batch row
    1 without use_valid (row1 'masked_mean': K3 gives the mean of V), and
    exact scores past the clamp at C 64 and 256 (row1 'above_clamp')."""
    for case in kernel_cases(gen, dtype):
        yield (*case, 1.0)
        if case[-1] == "masked":
            yield ("fully_masked_row_no_valid", *case[1:5], False,
                   "masked_mean", 1.0)
    for c in (64, 256):
        q, k, v, bias, scale = above_clamp_inputs(gen, c, dtype)
        yield f"above_clamp_c{c}", q, k, v, bias, True, "above_clamp", scale


def phase_kernel_online() -> dict:
    """K3 (o and lse) vs its plain version; a fully-masked row has lse
    -1e30 and o 0 (use_valid) or the mean of V (not); returns the worst
    error."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    neg = float(torch.tensor(fa.NEG_INF))
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias, uv, row1, scale in online_cases(gen, dtype):
            o, lse = fk.flash_fwd_online(q, k, v, bias, scale, uv)
            torch.cuda.synchronize()
            want_o, want_lse = fk.flash_fwd_online_reference(
                q, k, v, bias, scale, uv)
            outs = {"o": agreement(o, want_o), "lse": agreement(lse, want_lse)}
            if row1 in ("masked", "masked_mean"):
                mean_v = v[1].float().mean(0).expand(q.shape[1], -1)
                outs["o"]["expected"] = bool((lse[1] == neg).all()) and (
                    row1_as_expected(o, "masked") if uv
                    else agreement(o[1], mean_v.to(dtype))["ok"])
            elif row1 == "above_clamp":
                outs["lse"]["expected"] = float(lse.max()) > fk._NOMAX_CLAMP
            else:
                outs["o"]["expected"] = row1_as_expected(o, row1)
            worst = max(worst, emit_case("kernel_online", name, q, k, uv,
                                         outs))
    return {"max_abs_err": worst}


def phase_kernel_bwd_noclamp() -> dict:
    """K4 with clamp=False vs its plain version on K3's plain o and lse;
    where scores pass the clamp, the clamped kernel must give another dQ.
    Returns the worst error."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        cases = (*online_cases(gen, dtype),
                 *((*case, 1.0) for case in bwd_edge_cases(gen, dtype)))
        for name, q, k, v, bias, uv, row1, scale in cases:
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            o, lse = fk.flash_fwd_online_reference(q, k, v, bias, scale, uv)
            got = fk.flash_bwd(q, k, v, bias, o, lse, do, scale, uv,
                               clamp=False)
            torch.cuda.synchronize()
            want = fk.flash_bwd_reference(q, k, v, bias, o, lse, do, scale,
                                          uv, clamp=False)
            outs = {n: agreement(g, w)
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            if row1 == "above_clamp":
                clamped = fk.flash_bwd(q, k, v, bias, o, lse, do, scale, uv)
                outs["dq"]["expected"] = bool(
                    all(torch.isfinite(g).all() for g in got)
                    and not torch.allclose(clamped[0].float(),
                                           got[0].float()))
            elif row1 == "nan":
                outs["dq"]["expected"] = row1_as_expected(got[0], row1)
                outs["dk"]["expected"] = bool(torch.isnan(got[1][1]).all())
            elif row1 == "masked":
                outs["dq"]["expected"] = row1_as_expected(got[0], row1)
            worst = max(worst, emit_case("kernel_bwd_noclamp", name, q, k, uv,
                                         outs))
            del o, lse, got, want
    return {"max_abs_err": worst}


def phase_serving(card: str, safe: bool = False) -> dict:
    """The serving path: 16 requests through the micro-batcher, then the
    logits of one forward through the kernel against the plain path.
    `safe` runs it with the safe softmax on (phase `safe_serving`): K3 in
    place of K1."""
    phase = "safe_serving" if safe else "serving"
    kname = "K3" if safe else "K1"
    attr, plain = (("flash_fwd_online", fk.flash_fwd_online_reference)
                   if safe else
                   ("flash_fwd_nomax", fk.flash_fwd_nomax_reference))
    t0 = time.monotonic()
    runner, img_size = serve.build_model_runner(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    zeros = np.zeros((BATCH, img_size, img_size, 3), np.uint8)
    runner(zeros).cpu()                          # warm-up: cuDNN plans
    setup_s = time.monotonic() - t0

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (img_size, img_size, 3)).astype(np.uint8)
              for _ in range(16)]
    batcher = serve._Batcher(runner, BATCH, max_wait_ms=20.0)
    zero_launches()                              # the main path's run
    with ThreadPoolExecutor(4) as ex:
        answers = list(ex.map(batcher.predict, images))
    counts = kernel_launches()
    launches = counts[kname]
    metrics = batcher.metrics()
    check(metrics["requests"] == 16 and metrics["errors"] == 0,
          f"{phase}: 16 requests answered: {metrics}")
    check(launches == 6 * metrics["batches"] and launches > 0
          and sum(counts.values()) == launches,
          f"{phase}: 6 {kname} launches per forward, no other kernel: "
          f"{counts}, {metrics['batches']} forwards")

    equal = 0
    for img, ans in zip(images, answers):
        direct = runner(np.stack([img] * BATCH))[0].cpu().numpy()
        equal += int(ans.shape == (img_size, img_size)
                     and ans.dtype == np.uint8 and np.array_equal(ans, direct))
    check(equal == 16, f"{phase}: answers equal direct runner calls "
          f"({equal}/16)")

    # logits of the kernel path vs the plain-version path, same weights
    forward, params, masks, cfg = serve.build_inference_fn(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    x = torch.from_numpy(np.stack(images[:BATCH])).cuda().float() / 255.0
    plans = mu.precompute_mask_plans(masks)
    with torch.no_grad():
        zero_launches()
        out_k, _ = mu.apply(params, None, x, cfg=cfg, masks=masks,
                            folded=True, mask_plans=plans)
        one = kernel_launches()
        check(one[kname] == 6 and sum(one.values()) == 6,
              f"{phase}: one forward launches {kname} 6 times and no other "
              f"kernel: {one}")
        kernel_fn = getattr(fk, attr)
        setattr(fk, attr, plain)
        try:
            out_p, _ = mu.apply(params, None, x, cfg=cfg, masks=masks,
                                folded=True, mask_plans=plans)
        finally:
            setattr(fk, attr, kernel_fn)
    lk, lp = out_k.semantic.float(), out_p.semantic.float()
    finite = bool(torch.isfinite(lk).all())
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    emit(phase=phase, card=card, setup_s=setup_s, requests=16,
         forwards=metrics["batches"], kernel_launches=launches,
         launches_one_forward=one,
         answers_equal_direct=equal, logits_shape=list(lk.shape),
         logits_finite=finite, logits_max_abs_diff_vs_plain=err,
         logits_max_abs=scale, tol=SERVE_LOGIT_TOL * scale,
         argmax_agreement=agree, avg_batch_fill=metrics["avg_batch_fill"])
    check(list(lk.shape) == [BATCH, IMG, IMG, NUM_CLASSES] and finite,
          f"{phase}: logits finite, [8,128,128,150]")
    check(err <= SERVE_LOGIT_TOL * scale, f"{phase}: logits kernel vs plain")
    check(agree >= SERVE_ARGMAX_AGREE,
          f"{phase}: argmax agreement kernel vs plain")
    return {"runner": runner, "launches": launches, "images": images}


def serve_wall_and_profile(card: str, runner, batch, prefix: str,
                           tag: str) -> None:
    """Serving forward wall time (best of 3 x 10) and a device profile of
    three forwards; `tag` names the flash kernel in the profile."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            runner(batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    emit(phase=f"{prefix}serve_time", card=card, ms_per_batch=best * 1e3,
         img_per_s=BATCH / best, batch=BATCH, windows="best of 3 x 10")

    # device profile of three serving forwards: where the time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            runner(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_kernel_rows(prof)
    total_dev = sum(r[0] for r in rows)
    flash_us = sum(r[0] for r in rows if tag in r[1])
    emit(phase=f"{prefix}serve_profile", card=card, forwards=3,
         device_ms_per_forward=total_dev / 3e3 if rows else "not measured",
         wall_ms_per_forward=wall_us / 3e3,
         device_busy_share=total_dev / wall_us if rows else "not measured",
         flash_kernel_share=flash_us / total_dev if rows else "not measured",
         device_launches_per_forward=sum(r[2] for r in rows) / 3,
         top=[{"name": k[:90], "ms_per_forward": us / 3e3, "calls": n // 3}
              for us, k, n in rows[:12]])


def phase_times(card: str, serving: dict) -> dict:
    serve_wall_and_profile(card, serving["runner"],
                           np.stack(serving["images"][:BATCH]), "",
                           "fwd_nomax")
    totals = forward_shape_times(card, "attn_time", fk.flash_fwd_nomax,
                                 fk.flash_fwd_nomax_reference, seed=1)
    totals["launches"] = serving["launches"]
    return totals


def forward_shape_times(card: str, phase: str, kernel, plain,
                        seed: int, lse: bool = False) -> dict:
    """Per serving attention shape, bf16: the forward `kernel` and its
    `plain` version (both called (q, k, v, bias, 1.0, use_valid)), the
    library's SDPA with the same additive mask, and the bound (plus the
    lse bytes when `lse`). Returns the sums over the six shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, lq, lk, c, uv in SERVING_SHAPES:
        q, k, v, bias = attention_inputs(gen, lq, lk, c, uv, torch.bfloat16)
        ms = device_ms(lambda: kernel(q, k, v, bias, 1.0, uv), iters=20)
        plain_ms = device_ms(lambda: plain(q, k, v, bias, 1.0, uv), iters=2)
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        amask = bias[:, None].to(q.dtype)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=amask, scale=1.0), iters=20)
        t_bytes, t_ops = bound_ms(q, k, bias)
        if lse:
            t_bytes += 4 * BATCH * lq / PEAK["bytes"] * 1e3
        bnd = max(t_bytes, t_ops)
        by = "bytes" if t_bytes > t_ops else "operations"
        emit(phase=phase, card=card, layer=name, lq=lq, lk=lk, c=c,
             batch=BATCH, dtype="bfloat16", use_valid=uv, ms=ms,
             plain_ms=plain_ms, library_ms=lib, bound_ms=bnd, bound_by=by,
             share_of_bound=bnd / ms)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib), ("bound_ms", bnd),
                         ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
            totals[key] += val
    return totals


def exact_zero_grad(name: str) -> bool:
    """Parameters whose gradient is zero in exact arithmetic, so that any
    implementation returns rounding noise there: each attention's key bias
    (softmax is shift-invariant), the affine of the BatchNorm that feeds
    the Down/Up blocks' trailing BatchNorm (which normalises it away), and
    the conv bias before the final BatchNorm."""
    return (name.endswith(".key.bias") or name == "final_layer.0.bias"
            or (name.startswith("downsample") and ".2.conv_block.4." in name)
            or (name.startswith("upsample") and ".1.conv_block.4." in name))


def counted_wrappers() -> dict:
    """Every kernel's wrapper, the holder of its launch counter."""
    return {"K1": fk.flash_fwd_nomax, "K2": fk.flash_fwd_nomax_lse,
            "K3": fk.flash_fwd_online, "K4": fk.flash_bwd,
            "K5": softmax_ab.old_flash_fwd, "K6": softmax_ab.nomax65_fwd,
            "K7": bf16_tool.flash_fwd_bf16}


def kernel_launches() -> dict:
    return {k: fn.launches for k, fn in counted_wrappers().items()}


def zero_launches() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def phase_train(card: str, safe: bool = False) -> dict:
    """The training path: one step, one eval step, gradients through the
    kernels against the plain path, 10 steps. `safe` runs it with the safe
    softmax on (phases `safe_train*`): K3 in place of K2 (and of K1 in
    the eval step), K4 without its clamp."""
    prefix = "safe_" if safe else ""
    fwd = "K3" if safe else "K2"
    t0 = time.monotonic()
    recipe = recipes.get("ade_semantic")
    cfg = train_loop.model_config(recipe, NUM_CLASSES,
                                  compute_dtype="bfloat16")
    ts = train_loop.setup_state(recipe, cfg,
                                train_loop.make_optimizer(recipe),
                                batch_size=BATCH, device="cuda")
    plans = mu.precompute_mask_plans(ts.masks)
    task = train_step.TaskConfig()
    step = train_step.make_train_step(cfg, task, mask_plans=plans,
                                      device="cuda")
    eval_step = train_step.make_eval_step(cfg, task, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (BATCH, IMG, IMG, 3)).astype(np.float32)).cuda(),
             "label": torch.from_numpy(rng.integers(
                 0, NUM_CLASSES, (BATCH, IMG, IMG))).cuda()}
    setup_s = time.monotonic() - t0

    # the main path: one training step, counters zeroed just before it;
    # the clamp flag of each backward launch is recorded on the way
    clamps = []
    bwd_kernel = fk.flash_bwd

    def recorded_bwd(*args, **kw):
        clamps.append(kw.get("clamp", True))
        return bwd_kernel(*args, **kw)

    fk.flash_bwd = recorded_bwd
    try:
        zero_launches()
        ts, metrics = step(ts, batch)
        torch.cuda.synchronize()
        step_launches = kernel_launches()
    finally:
        fk.flash_bwd = bwd_kernel
    want = dict.fromkeys(counted_wrappers(), 0)
    check(step_launches == {**want, fwd: 6, "K4": 6}
          and clamps == [not safe] * 6,
          f"one {prefix}train step launches {fwd} 6, K4 6 (clamp "
          f"{not safe}), no other kernel: {step_launches}, clamps {clamps}")
    zero_launches()
    result = eval_step(ts, batch, plans)
    torch.cuda.synchronize()
    eval_launches = kernel_launches()
    check(eval_launches == {**want, "K3" if safe else "K1": 6},
          f"one {prefix}eval step launches {'K3' if safe else 'K1'} 6: "
          f"{eval_launches}")
    check(list(result["pred"].shape) == [BATCH, IMG, IMG]
          and bool(torch.isfinite(result["metrics"]["loss"])),
          f"{prefix}eval step: finite loss, [8,128,128] predictions")

    # gradients through the kernels vs through their plain versions: same
    # state, batch and dropout draws, in f32 and in bf16
    gen_state = ts.generator.get_state()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")

    def grads(model_cfg, plain: bool):
        ts.generator.set_state(gen_state)
        fn = train_step.make_grads_and_metrics(model_cfg, task)
        kernels = (fk.flash_fwd_nomax_lse, fk.flash_fwd_online,
                   fk.flash_bwd)
        if plain:
            fk.flash_fwd_nomax_lse = functools.partial(
                fk.flash_fwd_nomax_reference, with_lse=True)
            fk.flash_fwd_online = fk.flash_fwd_online_reference
            fk.flash_bwd = fk.flash_bwd_reference
        try:
            g, m, _ = fn(ts.params, ts.model_state, batch, ts.masks, plans,
                         ts.generator)
        finally:
            fk.flash_fwd_nomax_lse, fk.flash_fwd_online, fk.flash_bwd = \
                kernels
        return ({k: v.double().flatten() for k, v in g.items()
                 if not exact_zero_grad(k)}, float(m["loss"]))

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))

    (k32, loss_k32), (p32, loss_p32) = grads(cfg32, False), grads(cfg32, True)
    cos32 = {n: cos(k32[n], p32[n]) for n in p32}
    del p32
    (kbf, loss_kbf), (pbf, loss_pbf) = grads(cfg, False), grads(cfg, True)
    plain_to_f32 = {n: cos(pbf[n], k32[n]) for n in pbf}
    signal = {n: c for n, c in plain_to_f32.items() if c >= BF16_SIGNAL_COS}
    margin = {n: cos(kbf[n], k32[n]) - signal[n] for n in signal}
    finite = all(bool(torch.isfinite(g).all()) for g in kbf.values())
    worst32, worst_bf = min(cos32, key=cos32.get), min(margin, key=margin.get)
    bf_vs_plain = {n: cos(kbf[n], pbf[n]) for n in pbf}
    least = min(bf_vs_plain, key=bf_vs_plain.get)
    emit(phase=f"{prefix}train_vs_plain", card=card,
         loss_f32_kernels=loss_k32,
         loss_f32_plain=loss_p32, loss_bf16_kernels=loss_kbf,
         loss_bf16_plain=loss_pbf,
         loss_bf16_rel_diff=abs(loss_kbf - loss_pbf) / abs(loss_pbf),
         loss_rtol=TRAIN_LOSS_RTOL, tensors_compared=len(cos32),
         f32_min_cosine=cos32[worst32], f32_min_cosine_tensor=worst32,
         f32_cos_limit=TRAIN_GRAD_COS,
         bf16_min_kernel_vs_plain_cosine=bf_vs_plain[least],
         bf16_min_kernel_vs_plain_tensor=least,
         bf16_that_tensor_cos_to_f32={"kernels": cos(kbf[least], k32[least]),
                                      "plain": plain_to_f32[least]},
         bf16_signal_tensors=len(signal),
         bf16_worst_margin_to_f32=margin[worst_bf],
         bf16_worst_margin_tensor=worst_bf,
         bf16_margin_limit=-BF16_COS_MARGIN, grads_finite=finite)
    check(cos32[worst32] >= TRAIN_GRAD_COS,
          f"{prefix}f32 train gradients, kernels vs plain")
    check(abs(loss_kbf - loss_pbf) <= TRAIN_LOSS_RTOL * abs(loss_pbf),
          f"{prefix}bf16 train loss, kernels vs plain")
    check(margin[worst_bf] >= -BF16_COS_MARGIN and finite,
          f"{prefix}bf16 train gradients as close to f32 as the plain "
          "path's")
    del k32, kbf, pbf

    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        ts, metrics = step(ts, batch)
        losses.append(float(metrics["loss"]))
    emit(phase=f"{prefix}train", card=card, setup_s=setup_s, batch=BATCH,
         step_launches=step_launches, step_bwd_clamps=clamps,
         eval_launches=eval_launches, losses=losses,
         miou_last=float(metrics["miou"]),
         eval_metrics={k: float(v) for k, v in result["metrics"].items()})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{prefix}{TRAIN_STEPS} steps: finite loss that falls")
    return {"ts": ts, "step": step, "batch": batch,
            "launches": step_launches}


def train_wall_and_profile(card: str, train: dict, prefix: str,
                           shares: dict) -> None:
    """Training step wall time (best of 3 x 10) and a device profile of 3
    steps; `shares` names the share keys and the kernel name each reads.
    Drops the training state afterwards."""
    step, batch, ts = train["step"], train["batch"], train["ts"]
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ts, _ = step(ts, batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    emit(phase=f"{prefix}train_time", card=card, ms_per_step=best * 1e3,
         img_per_s=BATCH / best, batch=BATCH, windows="best of 3 x 10")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ts, _ = step(ts, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_kernel_rows(prof)
    total = sum(r[0] for r in rows)
    share = (lambda tag: sum(r[0] for r in rows if tag in r[1]) / total
             if rows else "not measured")
    emit(phase=f"{prefix}train_profile", card=card, steps=3,
         device_ms_per_step=total / 3e3 if rows else "not measured",
         wall_ms_per_step=wall_us / 3e3,
         device_busy_share=total / wall_us if rows else "not measured",
         **{key: share(tag) for key, tag in shares.items()},
         device_launches_per_step=sum(r[2] for r in rows) / 3,
         top=[{"name": k[:90], "ms_per_step": us / 3e3, "calls": n // 3}
              for us, k, n in rows[:15]])
    del ts, train["ts"]


def bwd_bound_ms(q, k, bias) -> tuple[float, float]:
    """K4's least time: bytes (q, k, v, dO, lse, delta, bias read once;
    dQ in f32, dK, dV written once) against operations (five products and
    one exp2 per visible (query, key) pair)."""
    b, lq, c = q.shape
    visible = int((bias > fa.NEG_INF * 0.5).sum())
    e = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * e + 2 * 4 * b * lq \
        + bias.numel() * 4 + 4 * q.numel()
    t_ops = max(10 * lq * visible * c / PEAK[q.dtype],
                lq * visible / PEAK["exp2"])
    return nbytes / PEAK["bytes"] * 1e3, t_ops * 1e3


# K4's kernels in a profile, whichever body ran (bwd_wgmma, bwd_bf16,
# bwd_f32)
K4_TAG = "namespace)::bwd_"


def phase_train_time(card: str, train: dict) -> dict:
    train_wall_and_profile(card, train, "", {"k2_share": "fwd_nomax",
                                             "k4_share": K4_TAG})
    gen = torch.Generator(device="cuda").manual_seed(4)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")
    totals = {"K2": dict.fromkeys(keys, 0.0), "K4": dict.fromkeys(keys, 0.0)}
    for name, lq, lk, c, uv in SERVING_SHAPES:
        q, k, v, bias = attention_inputs(gen, lq, lk, c, uv, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        o, lse = fk.flash_fwd_nomax_lse(q, k, v, bias, 1.0, uv)
        q4, k4, v4 = (t[:, None].detach().requires_grad_()
                      for t in (q, k, v))
        amask = bias[:, None].to(q.dtype)
        lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=amask,
                                                 scale=1.0)
        do4 = do[:, None]
        t_bytes, t_ops = bound_ms(q, k, bias)
        fwd = {"ms": device_ms(lambda: fk.flash_fwd_nomax_lse(
                   q, k, v, bias, 1.0, uv), iters=20),
               "plain_ms": device_ms(lambda: fk.flash_fwd_nomax_reference(
                   q, k, v, bias, 1.0, uv, with_lse=True), iters=2),
               "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=amask, scale=1.0), iters=20),
               "bytes_ms": t_bytes + 4 * lse.numel() / PEAK["bytes"] * 1e3,
               "ops_ms": t_ops}
        t_bytes, t_ops = bwd_bound_ms(q, k, bias)
        bwd = {"ms": device_ms(lambda: fk.flash_bwd(
                   q, k, v, bias, o, lse, do, 1.0, uv), iters=10),
               "plain_ms": device_ms(lambda: fk.flash_bwd_reference(
                   q, k, v, bias, o, lse, do, 1.0, uv), iters=2),
               "library_ms": device_ms(lambda: torch.autograd.grad(
                   lib_out, (q4, k4, v4), do4, retain_graph=True), iters=10),
               "bytes_ms": t_bytes, "ops_ms": t_ops}
        bwd["body"] = fk.flash_bwd_body(c, torch.bfloat16)
        for kname, row in (("K2", fwd), ("K4", bwd)):
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = ("bytes" if row["bytes_ms"] > row["ops_ms"]
                               else "operations")
            emit(phase="train_attn_time", card=card, kernel=kname,
                 layer=name, lq=lq, lk=lk, c=c, batch=BATCH, dtype="bfloat16",
                 use_valid=uv, **row, share_of_bound=row["bound_ms"] / row["ms"])
            for key in keys:
                totals[kname][key] += row[key]
        del q4, k4, v4, lib_out, o, lse
    return totals


def phase_safe(card: str) -> dict:
    """The serving and training paths with the safe softmax on: their
    checks, wall times and device profiles. Returns the launches of K3
    (16 served requests + one step) and of K4 (one step)."""
    fa._SAFE_SOFTMAX = True
    try:
        serving = phase_serving(card, safe=True)
        serve_wall_and_profile(card, serving["runner"],
                               np.stack(serving["images"][:BATCH]), "safe_",
                               "fwd_online")
        del serving["runner"]
        train = phase_train(card, safe=True)
        train_wall_and_profile(card, train, "safe_",
                               {"k3_share": "fwd_online",
                                "k4_share": K4_TAG})
    finally:
        fa._SAFE_SOFTMAX = False
    return {"K3": serving["launches"] + train["launches"]["K3"],
            "K4": train["launches"]["K4"]}


def tool_cases() -> list:
    """(kernel, name, call, plain call, bound (bytes ms, ops ms), library
    call) of K5, K6 (D and E) and K7 at their tools' attn6 inputs."""
    q, k, v, bias = softmax_ab.attn6_inputs(BATCH)
    q65, k65 = softmax_ab.bias_as_channel(q, k, bias)
    bq, bk, bv, bbias = bf16_tool.attn6_inputs(BATCH)
    lq, lk, c = q.shape[1], k.shape[1], q.shape[2]
    e = q.element_size()
    k6_bytes = (q65.numel() + k65.numel() + v.numel() + q.numel()) * e
    k6_ops = max(2 * BATCH * lq * lk * (C65 + c) / PEAK[torch.bfloat16],
                 BATCH * lq * lk / PEAK["exp2"])
    k5_bound = bound_ms(q, k, bias)
    k7_bound = bound_ms(bq, bk, bbias)
    lse_ms = 4 * BATCH * lq / PEAK["bytes"] * 1e3
    sdpa = (lambda q_, k_, v_, b_: lambda: F.scaled_dot_product_attention(
        q_[:, None], k_[:, None], v_[:, None],
        attn_mask=b_[:, None].to(q_.dtype), scale=1.0))
    return [
        ("K5", "old_flash_fwd",
         lambda: softmax_ab.old_flash_fwd(q, k, v, bias),
         lambda: softmax_ab.old_flash_fwd_reference(q, k, v, bias),
         (k5_bound[0] + lse_ms, k5_bound[1]), sdpa(q, k, v, bias)),
        ("K6", "nomax65_fwd_D",
         lambda: softmax_ab.nomax65_fwd(q65, k65, v, True),
         lambda: softmax_ab.nomax65_fwd_reference(q65, k65, v, True),
         (k6_bytes / PEAK["bytes"] * 1e3, k6_ops * 1e3),
         lambda: F.scaled_dot_product_attention(
             q65[:, None], k65[:, None], v[:, None], scale=math.log(2.0))),
        ("K6", "nomax65_fwd_E",
         lambda: softmax_ab.nomax65_fwd(q65, k65, v, False),
         lambda: softmax_ab.nomax65_fwd_reference(q65, k65, v, False),
         (k6_bytes / PEAK["bytes"] * 1e3, k6_ops * 1e3),
         lambda: F.scaled_dot_product_attention(
             q65[:, None], k65[:, None], v[:, None], scale=math.log(2.0))),
        ("K7", "flash_fwd_bf16", lambda: bf16_tool.flash_fwd_bf16(
            bq, bk, bv, bbias),
         lambda: bf16_tool.flash_fwd_bf16_reference(bq, bk, bv, bbias),
         (k7_bound[0] + lse_ms, k7_bound[1]), sdpa(bq, bk, bv, bbias)),
    ]


def phase_tools(card: str) -> dict:
    """K5, K6 and K7 against their plain versions at the tools' inputs,
    the three tool mains (the launches counted), then each kernel timed.
    Returns {kernel: {launches, max_abs_err, ms, plain_ms, library_ms,
    bytes_ms, ops_ms, bound_ms}} (K6: the clamped variant D's times)."""
    out = {}
    cases = tool_cases()
    for kname, name, call, plain, _, _ in cases:
        got, want = call(), plain()
        torch.cuda.synchronize()
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        outs = {n: agreement(g, w) for n, g, w in zip(("o", "lse"), got, want)}
        ok = all(a["ok"] for a in outs.values())
        emit(phase="tools", case=name, dtype="bfloat16",
             shape=list(got[0].shape), outputs=outs, ok=ok)
        check(ok, f"tools {name}")
        err = max(a["max_abs_err"] for a in outs.values())
        out.setdefault(kname, {"max_abs_err": 0.0})
        out[kname]["max_abs_err"] = max(out[kname]["max_abs_err"], err)
        del got, want

    zero_launches()                              # the tools' main paths
    printed = {"softmax_ab": softmax_ab.main([]),
               "softmax_ab_2": softmax_ab.main2(["2"]),
               "bf16_softmax_experiment": bf16_tool.main()}
    torch.cuda.synchronize()
    counts = kernel_launches()
    emit(phase="tool_mains", card=card, printed=printed, launches=counts)
    check(all(counts[kn] > 0 for kn in ("K5", "K6", "K7")),
          f"the tool mains launch K5, K6 and K7: {counts}")
    check(all(math.isfinite(float(t)) for p in printed.values()
              for t in p["ms"].values()), "tool mains: finite times")

    for kname, name, call, plain, (t_bytes, t_ops), lib in cases:
        row = {"ms": device_ms(call, iters=20),
               "plain_ms": device_ms(plain, iters=2),
               "library_ms": device_ms(lib, iters=20),
               "bytes_ms": t_bytes, "ops_ms": t_ops,
               "bound_ms": max(t_bytes, t_ops)}
        emit(phase="tool_time", card=card, kernel=kname, case=name,
             batch=BATCH, dtype="bfloat16", **row,
             bound_by="bytes" if t_bytes > t_ops else "operations",
             share_of_bound=row["bound_ms"] / row["ms"])
        if name != "nomax65_fwd_E":
            out[kname].update(row)
    for kname in out:
        out[kname]["launches"] = counts[kname]
    return out


def kernel_entry(name, source, replaces, launches, err, t, **extra) -> dict:
    return {**extra, "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] > t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    card = phase_device()
    kernel = phase_kernel()
    kernel_lse = phase_kernel_lse()
    kernel_bwd = phase_kernel_bwd()
    serving = phase_serving(card)
    totals = phase_times(card, serving)
    del serving
    train = phase_train(card)
    train_totals = phase_train_time(card, train)
    kernel_online = phase_kernel_online()
    kernel_bwd_noclamp = phase_kernel_bwd_noclamp()
    safe = phase_safe(card)
    online_totals = forward_shape_times(
        card, "online_attn_time", fk.flash_fwd_online,
        fk.flash_fwd_online_reference, seed=7, lse=True)
    tools = phase_tools(card)
    # every kernel of the port; K1-K4 times are summed over the six
    # attention shapes (one forward's or one step's launches), K5-K7's are
    # one call at their tool's attn6 inputs (K6: variant D), bf16, batch
    # 8; launches are those of the paths' own runs: 16 served requests
    # (K1), one training step (K2), 16 safe requests and one safe step
    # (K3), one step of each path (K4, clamped then not), the tool mains
    # (K5-K7)
    fwd_src = "maskunet_tpu_torch/csrc/flash_fwd_nomax.cu"
    online_src = "maskunet_tpu_torch/csrc/flash_fwd_online.cu"
    kernels = [
        kernel_entry("flash_fwd_nomax", fwd_src,
                     "maskunet_tpu/ops/flash_attention.py:164",
                     totals["launches"], kernel["max_abs_err"], totals),
        kernel_entry("flash_fwd_nomax_lse", fwd_src,
                     "maskunet_tpu/ops/flash_attention.py:267",
                     train["launches"]["K2"], kernel_lse["max_abs_err"],
                     train_totals["K2"]),
        kernel_entry("flash_fwd_online", online_src,
                     "maskunet_tpu/ops/flash_attention.py:111",
                     safe["K3"], kernel_online["max_abs_err"], online_totals),
        kernel_entry("flash_bwd", "maskunet_tpu_torch/csrc/flash_bwd.cu",
                     "maskunet_tpu/ops/flash_attention.py:323",
                     train["launches"]["K4"] + safe["K4"],
                     max(kernel_bwd["max_abs_err"],
                         kernel_bwd_noclamp["max_abs_err"]),
                     train_totals["K4"],
                     bodies_bf16={str(c): fk.flash_bwd_body(c, torch.bfloat16)
                                  for c in fk.KERNEL_CHANNELS}),
        kernel_entry("old_flash_fwd", online_src, "tools/softmax_ab.py:29",
                     tools["K5"]["launches"], tools["K5"]["max_abs_err"],
                     tools["K5"]),
        kernel_entry("nomax65_fwd",
                     "maskunet_tpu_torch/csrc/flash_fwd_nomax65.cu",
                     "tools/softmax_ab.py:157", tools["K6"]["launches"],
                     tools["K6"]["max_abs_err"], tools["K6"]),
        kernel_entry("flash_fwd_bf16", online_src,
                     "tools/bf16_softmax_experiment.py:32",
                     tools["K7"]["launches"], tools["K7"]["max_abs_err"],
                     tools["K7"]),
    ]
    emit(phase="done", seconds=time.monotonic() - t0, failures=failures)
    if failures:
        print(f"chip_smoke: {len(failures)} failure(s): {failures}",
              file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
