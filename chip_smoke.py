#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what it computes.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure exits non-zero and prints no
final result):

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of both kernel libraries from
   maskunet_tpu_torch/csrc (seconds, ptxas registers and spills).
2. kernel: K1 `flash_fwd_nomax` against its plain PyTorch version at the
   six serving attention shapes (batch 8, 128x128 images) in bf16 and f32,
   plus a ragged shape, a fully-masked row (must give 0) and a NaN-poisoned
   K row (must give NaN).
3. kernel_lse, kernel_bwd: K2 `flash_fwd_nomax_lse` (o and lse) and K4
   `flash_bwd` (dq, dk, dv) against their plain versions at the same
   shapes and cases, both dtypes.
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
   the library's forward and backward.

It imports torch, numpy and the port, nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
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
        for name, q, k, v, bias, uv, row1 in kernel_cases(gen, dtype):
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


def phase_serving(card: str) -> dict:
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
    fk.flash_fwd_nomax.launches = 0              # the main path's run
    with ThreadPoolExecutor(4) as ex:
        answers = list(ex.map(batcher.predict, images))
    launches = fk.flash_fwd_nomax.launches
    metrics = batcher.metrics()
    check(metrics["requests"] == 16 and metrics["errors"] == 0,
          f"16 requests answered: {metrics}")
    check(launches == 6 * metrics["batches"] and launches > 0,
          f"6 kernel launches per forward: {launches} launches, "
          f"{metrics['batches']} forwards")

    equal = 0
    for img, ans in zip(images, answers):
        direct = runner(np.stack([img] * BATCH))[0].cpu().numpy()
        equal += int(ans.shape == (img_size, img_size)
                     and ans.dtype == np.uint8 and np.array_equal(ans, direct))
    check(equal == 16, f"answers equal direct runner calls ({equal}/16)")

    # logits of the kernel path vs the plain-version path, same weights
    forward, params, masks, cfg = serve.build_inference_fn(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    x = torch.from_numpy(np.stack(images[:BATCH])).cuda().float() / 255.0
    plans = mu.precompute_mask_plans(masks)
    with torch.no_grad():
        before = fk.flash_fwd_nomax.launches
        out_k, _ = mu.apply(params, None, x, cfg=cfg, masks=masks,
                            folded=True, mask_plans=plans)
        check(fk.flash_fwd_nomax.launches - before == 6,
              "one forward launches the kernel 6 times")
        kernel_fn = fk.flash_fwd_nomax
        fk.flash_fwd_nomax = fk.flash_fwd_nomax_reference
        try:
            out_p, _ = mu.apply(params, None, x, cfg=cfg, masks=masks,
                                folded=True, mask_plans=plans)
        finally:
            fk.flash_fwd_nomax = kernel_fn
    lk, lp = out_k.semantic.float(), out_p.semantic.float()
    finite = bool(torch.isfinite(lk).all())
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    emit(phase="serving", card=card, setup_s=setup_s, requests=16,
         forwards=metrics["batches"], kernel_launches=launches,
         answers_equal_direct=equal, logits_shape=list(lk.shape),
         logits_finite=finite, logits_max_abs_diff_vs_plain=err,
         logits_max_abs=scale, tol=SERVE_LOGIT_TOL * scale,
         argmax_agreement=agree, avg_batch_fill=metrics["avg_batch_fill"])
    check(list(lk.shape) == [BATCH, IMG, IMG, NUM_CLASSES] and finite,
          "logits finite, [8,128,128,150]")
    check(err <= SERVE_LOGIT_TOL * scale, "logits kernel vs plain")
    check(agree >= SERVE_ARGMAX_AGREE, "argmax agreement kernel vs plain")
    return {"runner": runner, "launches": launches, "images": images}


def phase_times(card: str, serving: dict) -> dict:
    runner = serving["runner"]
    batch = np.stack(serving["images"][:BATCH])
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            runner(batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    emit(phase="serve_time", card=card, ms_per_batch=best * 1e3,
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
    flash_us = sum(r[0] for r in rows if "fwd_nomax" in r[1])
    emit(phase="serve_profile", card=card, forwards=3,
         device_ms_per_forward=total_dev / 3e3 if rows else "not measured",
         wall_ms_per_forward=wall_us / 3e3,
         device_busy_share=total_dev / wall_us if rows else "not measured",
         flash_kernel_share=flash_us / total_dev if rows else "not measured",
         device_launches_per_forward=sum(r[2] for r in rows) / 3,
         top=[{"name": k[:90], "ms_per_forward": us / 3e3, "calls": n // 3}
              for us, k, n in rows[:12]])

    gen = torch.Generator(device="cuda").manual_seed(1)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, lq, lk, c, uv in SERVING_SHAPES:
        q, k, v, bias = attention_inputs(gen, lq, lk, c, uv, torch.bfloat16)
        ms = device_ms(lambda: fk.flash_fwd_nomax(q, k, v, bias, 1.0, uv),
                       iters=20)
        plain = device_ms(lambda: fk.flash_fwd_nomax_reference(
            q, k, v, bias, 1.0, uv), iters=2)
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        amask = bias[:, None].to(q.dtype)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=amask, scale=1.0), iters=20)
        t_bytes, t_ops = bound_ms(q, k, bias)
        bnd = max(t_bytes, t_ops)
        by = "bytes" if t_bytes > t_ops else "operations"
        emit(phase="attn_time", card=card, layer=name, lq=lq, lk=lk, c=c,
             batch=BATCH, dtype="bfloat16", use_valid=uv, ms=ms,
             plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
             share_of_bound=bnd / ms)
        totals["ms"] += ms
        totals["plain_ms"] += plain
        totals["library_ms"] += lib
        totals["bound_ms"] += bnd
        totals["bytes_ms"] += t_bytes
        totals["ops_ms"] += t_ops
    totals["launches"] = serving["launches"]
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


def kernel_launches() -> dict:
    return {"K1": fk.flash_fwd_nomax.launches,
            "K2": fk.flash_fwd_nomax_lse.launches,
            "K4": fk.flash_bwd.launches}


def zero_launches() -> None:
    fk.flash_fwd_nomax.launches = 0
    fk.flash_fwd_nomax_lse.launches = 0
    fk.flash_bwd.launches = 0


def phase_train(card: str) -> dict:
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

    # the main path: one training step, counters zeroed just before it
    zero_launches()
    ts, metrics = step(ts, batch)
    torch.cuda.synchronize()
    step_launches = kernel_launches()
    check(step_launches == {"K1": 0, "K2": 6, "K4": 6},
          f"one train step launches K2 6, K4 6, K1 0: {step_launches}")
    zero_launches()
    result = eval_step(ts, batch, plans)
    torch.cuda.synchronize()
    eval_launches = kernel_launches()
    check(eval_launches == {"K1": 6, "K2": 0, "K4": 0},
          f"one eval step launches K1 6: {eval_launches}")
    check(list(result["pred"].shape) == [BATCH, IMG, IMG]
          and bool(torch.isfinite(result["metrics"]["loss"])),
          "eval step: finite loss, [8,128,128] predictions")

    # gradients through the kernels vs through their plain versions: same
    # state, batch and dropout draws, in f32 and in bf16
    gen_state = ts.generator.get_state()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")

    def grads(model_cfg, plain: bool):
        ts.generator.set_state(gen_state)
        fn = train_step.make_grads_and_metrics(model_cfg, task)
        kernels = fk.flash_fwd_nomax_lse, fk.flash_bwd
        if plain:
            fk.flash_fwd_nomax_lse = functools.partial(
                fk.flash_fwd_nomax_reference, with_lse=True)
            fk.flash_bwd = fk.flash_bwd_reference
        try:
            g, m, _ = fn(ts.params, ts.model_state, batch, ts.masks, plans,
                         ts.generator)
        finally:
            fk.flash_fwd_nomax_lse, fk.flash_bwd = kernels
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
    emit(phase="train_vs_plain", card=card, loss_f32_kernels=loss_k32,
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
          "f32 train gradients, kernels vs plain")
    check(abs(loss_kbf - loss_pbf) <= TRAIN_LOSS_RTOL * abs(loss_pbf),
          "bf16 train loss, kernels vs plain")
    check(margin[worst_bf] >= -BF16_COS_MARGIN and finite,
          "bf16 train gradients as close to f32 as the plain path's")
    del k32, kbf, pbf

    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        ts, metrics = step(ts, batch)
        losses.append(float(metrics["loss"]))
    emit(phase="train", card=card, setup_s=setup_s, batch=BATCH,
         step_launches=step_launches, eval_launches=eval_launches,
         losses=losses, miou_last=float(metrics["miou"]),
         eval_metrics={k: float(v) for k, v in result["metrics"].items()})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{TRAIN_STEPS} steps: finite loss that falls")
    return {"ts": ts, "step": step, "batch": batch,
            "launches": step_launches}


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


def phase_train_time(card: str, train: dict) -> dict:
    step, batch, ts = train["step"], train["batch"], train["ts"]
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ts, _ = step(ts, batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    emit(phase="train_time", card=card, ms_per_step=best * 1e3,
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
    emit(phase="train_profile", card=card, steps=3,
         device_ms_per_step=total / 3e3 if rows else "not measured",
         wall_ms_per_step=wall_us / 3e3,
         device_busy_share=total / wall_us if rows else "not measured",
         k2_share=share("fwd_nomax"), k4_share=share("bwd_bf16"),
         device_launches_per_step=sum(r[2] for r in rows) / 3,
         top=[{"name": k[:90], "ms_per_step": us / 3e3, "calls": n // 3}
              for us, k, n in rows[:15]])
    del ts, train["ts"]

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


def kernel_entry(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda", "source": source,
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
    # every kernel of the serving and training paths; times are summed
    # over the six attention shapes (one forward's or one step's launches),
    # bf16, batch 8; launches are those of the path's own run (16 served
    # requests for K1, one training step for K2 and K4)
    fwd_src = "maskunet_tpu_torch/csrc/flash_fwd_nomax.cu"
    kernels = [
        kernel_entry("flash_fwd_nomax", fwd_src,
                     "maskunet_tpu/ops/flash_attention.py:164",
                     totals["launches"], kernel["max_abs_err"], totals),
        kernel_entry("flash_fwd_nomax_lse", fwd_src,
                     "maskunet_tpu/ops/flash_attention.py:267",
                     train["launches"]["K2"], kernel_lse["max_abs_err"],
                     train_totals["K2"]),
        kernel_entry("flash_bwd", "maskunet_tpu_torch/csrc/flash_bwd.cu",
                     "maskunet_tpu/ops/flash_attention.py:323",
                     train["launches"]["K4"], kernel_bwd["max_abs_err"],
                     train_totals["K4"]),
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
