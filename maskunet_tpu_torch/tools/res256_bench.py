"""Measure the 256x256 capability on the card.

Counterpart of tools/res256_bench.py (SCALING.md claims that the flash
kernels let 65k-token, 256 px training fit one chip): inference and
train-step images/sec at 256x256 plus each phase's peak device memory.

    python -m maskunet_tpu_torch.tools.res256_bench [--batches 1 2 4]
        [--img 256] [--steps 10] [--device cuda|cpu]

Prints one JSON line per (phase, batch), each measured in a subprocess of
its own, so that an out-of-memory is a row with "error" and the other rows
survive. A host without CUDA is refused unless `--device cpu` is given
(the CPU runs the kernels' plain versions: minutes a step at 65k tokens,
and nothing about the card).

The rows carry the JAX tool's keys. `peak_hbm_gib` is
`torch.cuda.max_memory_allocated` after a `reset_peak_memory_stats` at the
start of the run, which stands for both JAX's runtime peak and XLA's
compiled memory analysis (the latter has no counterpart in eager
PyTorch). Added: `device_ms` (the card's kernel time a call, by the
profiler), `wall_ms` (the host's a call), the card's name and power limit
(`card`), the calls the run made and the flash-kernel launches it counted
(`calls`, `launches`), and for training the first and last losses.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the checkout's root, where `python -m maskunet_tpu_torch...` imports
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(img: int, batch: int, steps: int, train: bool,
        device: str = "cuda") -> dict:
    """One measurement: the ADE model (c_out 150, bf16, flash attention)
    at `img` px on random inputs from seed 0, weights from seed 0, cached
    masks from seed 1 with their compaction plans. Inference is the
    BN-folded, bf16-cast forward; training is the train step with AdamW
    5e-5 / 0.1 and the default TaskConfig on random labels out of 150.
    `steps` timed calls after one warm-up call, fenced by a scalar fetch,
    then the profiler's device time over 2 more calls."""
    import numpy as np
    import torch

    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.core.device import card_name, resolve_device
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.ops import flash_kernels as fk
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kernels = {"K1": fk.flash_fwd_nomax, "K2": fk.flash_fwd_nomax_lse,
               "K3": fk.flash_fwd_online, "K4": fk.flash_bwd}
    before = {k: fn.launches for k, fn in kernels.items()}
    cfg = mu.MaskAttnUNetConfig(c_out=150, img_size=img,
                                compute_dtype="bfloat16", attn_impl="flash")
    params, mstate = mu.init(torch.Generator().manual_seed(0), cfg)
    params = {k: v.to(dev) for k, v in params.items()}
    mstate = {k: v.to(dev) for k, v in mstate.items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, img, img, 3)).astype(np.float32)).to(dev)
    masks = tuple(m.to(dev) for m in mu.make_attention_masks(
        torch.Generator().manual_seed(1), batch, img))
    mask_plans = mu.precompute_mask_plans(masks)

    extra = {}
    if train:
        labels = torch.from_numpy(
            rng.integers(0, 150, (batch, img, img))).to(dev)
        ts = state_lib.create(torch.Generator(device=dev).manual_seed(2),
                              params, mstate, loop_lib.AdamW(5e-5, 1e-1),
                              masks=masks)
        del params, mstate
        fn = step_lib.make_train_step(cfg, step_lib.TaskConfig(),
                                      mask_plans=mask_plans, device=dev)
        bd = {"image": x, "label": labels}

        def call():
            return fn(ts, bd)[1]["loss"]

        first = float(call())
        if not np.isfinite(first):
            raise FloatingPointError(f"non-finite loss {first}")
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(call())
        last = float(losses[-1])         # host fetch = fence
        dt = time.perf_counter() - t0
        extra = {"loss_first": first, "loss_last": last,
                 "losses": [float(v) for v in losses]}
    else:
        with torch.no_grad():
            infer_params = mu.cast_params_for_inference(
                mu.fold_bn_for_inference(params, mstate, cfg))
        del params, mstate

        def call():
            with torch.no_grad():
                out, _ = mu.apply(infer_params, None, x, cfg=cfg,
                                  masks=masks, train=False, folded=True,
                                  mask_plans=mask_plans)
            return out.semantic

        out = call()
        if not np.isfinite(float(out[0, 0, 0, 0])):
            raise FloatingPointError("non-finite logits")
        t0 = time.perf_counter()
        for _ in range(steps):
            out = call()
        float(out[0, 0, 0, 0])
        dt = time.perf_counter() - t0
    device_ms = device_ms_per_call(call, calls=2) if on_card else None
    row = {
        "phase": "train" if train else "inference",
        "img_size": img,
        "batch": batch,
        "images_per_sec": round(batch * steps / dt, 2),
        "ms_per_image": round(1000 * dt / (batch * steps), 2),
        "peak_hbm_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30,
                               3) if on_card else None),
        "wall_ms": 1000 * dt / steps,
        "device_ms": device_ms,
        "card": card_name(dev),
        "calls": 1 + steps + (2 if on_card else 0),
        "launches": {k: fn.launches - before[k] for k, fn in kernels.items()},
        **extra,
    }
    return row


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="res256_bench")
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", nargs=2, default=None,
                    metavar=("PHASE", "BATCH"),
                    help="internal: one measurement in this process")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("res256_bench", args.device)
    if args.child:
        phase, batch = args.child
        print(json.dumps(run(args.img, int(batch), args.steps,
                             phase == "train", args.device)), flush=True)
        return

    # one subprocess per (phase, batch): the allocator's peak is
    # cumulative for the process, so a shared process would attribute the
    # largest run's peak to every row, and an out-of-memory would end it
    for batch in args.batches:
        for phase in ("inference", "train"):
            cmd = [sys.executable, "-m", "maskunet_tpu_torch.tools.res256_bench",
                   "--img", str(args.img), "--steps", str(args.steps),
                   "--device", args.device, "--child", phase, str(batch)]
            try:
                res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                                     timeout=1800, cwd=_ROOT)
            except subprocess.TimeoutExpired:
                # a stall on one row must not lose the rest
                print(json.dumps({
                    "phase": phase, "img_size": args.img, "batch": batch,
                    "error": "child timed out (1800s)"}), flush=True)
                continue
            lines = [ln for ln in (res.stdout or "").splitlines() if ln]
            if res.returncode == 0 and lines:
                print(lines[-1], flush=True)
            else:
                # OOM / abort is a data point: the capability boundary
                print(json.dumps({
                    "phase": phase, "img_size": args.img, "batch": batch,
                    "error": f"child exited {res.returncode}"}), flush=True)


if __name__ == "__main__":
    main()
