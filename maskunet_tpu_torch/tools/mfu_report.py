"""Exact FLOPs accounting and measured MFU for inference and training, on
the card.

Counterpart of tools/mfu_report.py: the same FLOPs model (per image,
batch-independent), the same timed forward and train step, and the share
of the card's peak they reach.

FLOPs model:
- conv h*w*kh*kw*cin*cout MACs (x2 for FLOPs); backward 2x forward
  (dW and dX each cost one forward-equivalent).
- attention: fused QKV projection 3*L*C^2 MACs; score/PV matmuls L*Lk*C
  each, where Lk is the COMPACTED key count (`_key_capacity(L)` on layers
  of >= COMPACT_MIN_TOKENS tokens). Forward = 2 score-shaped matmuls;
  the merged backward (K4) = 5 (dv, dp, dk, dq and the recomputed s).
- AdamW, BN, GELU, LayerNorm and dropout are elementwise work, not
  tensor-core FLOPs: excluded from the numerator (the usual MFU
  convention), which makes the MFU slightly conservative.

The peak is the H100 SXM's dense bf16 tensor-core rate from NVIDIA's data
sheet, a specification and not a measurement. MFU is given twice: on the
host's wall time (best of 3 windows, fenced by a scalar fetch, as the JAX
tool times it) and on the card's kernel time (the profiler's sum over the
calls; on a host-bound path the card idles between launches, and the wall
MFU says little about the card).

    python -m maskunet_tpu_torch.tools.mfu_report [batch] [--img 128|256]
        [--device cuda|cpu]

Prints the JAX tool's lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

H100_PEAK_BF16 = 989.4e12   # H100 SXM: dense bf16 tensor-core FLOP/s (spec)


def conv_flops(h, w, kh, kw, cin, cout):
    return 2 * h * w * kh * kw * cin * cout


def convblock_flops(h, w, cin, cout, mid=None):
    mid = mid if mid is not None else cout
    return (conv_flops(h, w, 3, 3, cin, mid)
            + conv_flops(h, w, 3, 3, mid, cout))


def model_flops(img: int = 128, c_out: int = 150,
                compacted: bool = True) -> dict:
    """Per-image forward tensor-core FLOPs, split conv trunk vs attention,
    and the train step's."""
    from maskunet_tpu_torch.ops.flash_attention import (COMPACT_MIN_TOKENS,
                                                        _key_capacity)

    s = img
    conv = convblock_flops(s, s, 3, 64)                      # initial
    # down1: @s/2 res(64->64) + (64->128) + trailing BN
    conv += convblock_flops(s // 2, s // 2, 64, 64)
    conv += convblock_flops(s // 2, s // 2, 64, 128)
    # down2: @s/4 res(128) + (128->256)
    conv += convblock_flops(s // 4, s // 4, 128, 128)
    conv += convblock_flops(s // 4, s // 4, 128, 256)
    # down3: @s/8 res(256) + (256->256)
    conv += convblock_flops(s // 8, s // 8, 256, 256)
    conv += convblock_flops(s // 8, s // 8, 256, 256)
    # bottom @s/8: 256->512, 512->512, 512->256
    conv += convblock_flops(s // 8, s // 8, 256, 512)
    conv += convblock_flops(s // 8, s // 8, 512, 512)
    conv += convblock_flops(s // 8, s // 8, 512, 256)
    # up1 @s/4: cat 512 -> res(512) + (512->128, mid 256)
    conv += convblock_flops(s // 4, s // 4, 512, 512)
    conv += convblock_flops(s // 4, s // 4, 512, 128, mid=256)
    # up2 @s/2: cat 256 -> res(256) + (256->64, mid 128)
    conv += convblock_flops(s // 2, s // 2, 256, 256)
    conv += convblock_flops(s // 2, s // 2, 256, 64, mid=128)
    # up3 @s: cat 128 -> res(128) + (128->64, mid 64)
    conv += convblock_flops(s, s, 128, 128)
    conv += convblock_flops(s, s, 128, 64, mid=64)
    conv += conv_flops(s, s, 1, 1, 64, c_out)                # final head
    # bilinear upsample as matmuls: row expand [t, t/2] @ x, then cols
    ups = 0
    for t, ch_in in ((s // 4, 256), (s // 2, 128), (s, 64)):
        ups += 2 * t * (t // 2) * (t // 2) * ch_in     # row expand
        ups += 2 * t * t * (t // 2) * ch_in            # col expand
    conv += ups

    attn_fwd = 0
    attn_bwd_extra = 0
    for l, c in ((((s // 2) ** 2), 128), (((s // 4) ** 2), 256),
                 (((s // 8) ** 2), 256), (((s // 4) ** 2), 128),
                 (((s // 2) ** 2), 64), ((s ** 2), 64)):
        lk = (_key_capacity(l) if compacted and l >= COMPACT_MIN_TOKENS
              else l)
        proj = 2 * l * c * 3 * c                       # fused QKV
        score_shaped = 2 * l * lk * c                  # one [L,Lk,C] matmul
        attn_fwd += proj + 2 * score_shaped            # QK^T + PV
        # backward: 5 score-shaped matmuls + d(QKV proj) 2x proj
        attn_bwd_extra += 2 * proj + 5 * score_shaped
    return {"conv_fwd": conv, "attn_fwd": attn_fwd,
            "fwd": conv + attn_fwd,
            "train": 3 * conv + attn_fwd + attn_bwd_extra}


def mfu(flops_per_image: int, batch: int, ms: float | None) -> float | None:
    """Share of H100_PEAK_BF16 that `batch` images in `ms` reach."""
    if not ms:
        return None
    return batch * flops_per_image / (ms / 1e3) / H100_PEAK_BF16


def _best_ms(fn, fence, iters: int, windows: int = 3) -> float:
    """Best-of-`windows` host wall ms a call over `iters` calls, each window
    fenced by `fence` (a scalar fetch)."""
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        fence(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def measure(batch: int, img: int = 128, device: str = "cuda",
            fwd_iters: int = 20, train_iters: int = 15) -> dict:
    """Wall and device ms of the eval forward (cached masks with plans) and
    of the train step (AdamW 5e-5 / 0.1, the default TaskConfig) of the ADE
    model (c_out 150, bf16) at `img` px on random inputs and labels, as
    the JAX tool times them."""
    import numpy as np
    import torch

    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    cfg = mu.MaskAttnUNetConfig(c_out=150, img_size=img,
                                compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, img, img, 3)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 150, (batch, img, img))).to(dev)
    params, mstate = mu.init(torch.Generator().manual_seed(0), cfg)
    params = {k: v.to(dev) for k, v in params.items()}
    mstate = {k: v.to(dev) for k, v in mstate.items()}
    masks = tuple(m.to(dev) for m in mu.make_attention_masks(
        torch.Generator().manual_seed(1), batch, img))
    plans = mu.precompute_mask_plans(masks)
    on_card = dev.type == "cuda"

    def fwd():
        with torch.no_grad():
            return mu.apply(params, mstate, x, cfg=cfg, masks=masks,
                            train=False, mask_plans=plans)[0].semantic

    def fence(out):
        float(out.float().sum())

    fence(fwd())
    fwd_ms = _best_ms(fwd, fence, fwd_iters)
    fwd_dev = device_ms_per_call(fwd) if on_card else None

    ts = state_lib.create(torch.Generator(device=dev).manual_seed(2), params,
                          mstate, loop_lib.AdamW(5e-5, 1e-1), masks=masks)
    step = step_lib.make_train_step(cfg, step_lib.TaskConfig(), device=dev)
    bd = {"image": x, "label": labels}

    def train():
        return step(ts, bd)[1]["loss"]

    float(train())
    train_ms = _best_ms(train, float, train_iters)
    train_dev = device_ms_per_call(train) if on_card else None
    return {"fwd_ms": fwd_ms, "fwd_device_ms": fwd_dev,
            "train_ms": train_ms, "train_device_ms": train_dev}


def main(argv: list[str] | None = None) -> dict:
    """Prints the FLOPs account and the measured MFU; returns the JSON
    line's fields."""
    from maskunet_tpu_torch.core.device import card_name, tool_device

    ap = argparse.ArgumentParser(prog="mfu_report")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = tool_device("mfu_report", args.device)
    batch, img = args.batch, args.img
    fl = model_flops(img)
    fl_dense = model_flops(img, compacted=False)
    print(f"per-image tensor-core FLOPs @{img}^2, c_out=150:")
    print(f"  conv trunk fwd : {fl['conv_fwd'] / 1e9:7.2f} G")
    print(f"  attention fwd  : {fl['attn_fwd'] / 1e9:7.2f} G "
          f"(compacted; {fl_dense['attn_fwd'] / 1e9:.2f} G dense — the "
          f"reference's own claim is 11 G total)")
    print(f"  forward total  : {fl['fwd'] / 1e9:7.2f} G")
    print(f"  train total    : {fl['train'] / 1e9:7.2f} G")

    t = measure(batch, img, str(dev))
    card = card_name(dev)
    out = {"img_size": img, "batch": batch,
           "gflop_fwd_per_image": fl["fwd"] / 1e9,
           "gflop_train_per_image": fl["train"] / 1e9,
           "gflop_attn_fwd_dense_per_image": fl_dense["attn_fwd"] / 1e9,
           **t, "peak_tflops": H100_PEAK_BF16 / 1e12}
    for name in ("fwd", "train"):
        for clock, ms in (("wall", t[f"{name}_ms"]),
                          ("device", t[f"{name}_device_ms"])):
            out[f"{name}_tflops_{clock}"] = (
                batch * fl[name] / (ms / 1e3) / 1e12 if ms else None)
            out[f"{name}_mfu_{clock}"] = mfu(fl[name], batch, ms)
    print(f"\nmeasured (batch {batch}, bf16, {card or dev.type}):")
    for name, label in (("fwd", "inference: "), ("train", "train:     ")):
        ms = t[f"{name}_ms"]
        mfu_wall = out[f"{name}_mfu_wall"]
        print(f"  {label}{ms:6.2f} ms ({batch / ms * 1e3:6.1f} img/s)  "
              f"{out[f'{name}_tflops_wall']:5.1f} TF/s  "
              f"MFU {100 * mfu_wall:4.1f}% (wall)", end="")
        if out[f"{name}_mfu_device"] is not None:
            print(f"; device {t[f'{name}_device_ms']:.2f} ms, MFU "
                  f"{100 * out[f'{name}_mfu_device']:4.1f}%", end="")
        print()
    print("\nNote: elementwise work (BN/GELU/LN/dropout/AdamW/metrics) is"
          " excluded from the numerator (standard MFU convention); the"
          " dense-equivalent MFU (crediting compaction's skipped work)"
          f" would read {100 * mfu(fl_dense['fwd'], batch, t['fwd_ms']):4.1f}%"
          " on inference (wall).")
    out["card"] = card
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
