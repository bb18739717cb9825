"""Same-process A/B of `remat_attention` on the card: its cost on the
train step and the memory headroom it buys.

Counterpart of tools/remat_ab.py. With `remat_attention` the six
attention blocks run under `torch.utils.checkpoint` in training
(`models/maskattn_unet._attn`): their activations are dropped after the
forward and recomputed in the backward (K2 runs twice a layer). Two
questions, at the ADE model (c_out 150, AdamW 1e-3 / 1e-4 as JAX's tool,
precomputed plans; bf16 on the card, f32 on the CPU as JAX picks f32 off
the TPU):

1. What does it cost a step? Both configurations, interleaved rounds
   (`fwd_breakdown.interleaved`, two rounds of `steps` steps after a
   warm-up step each), the card's kernel time a step beside.
2. What does it buy? The largest training batch of `BATCHES` that fits in
   each configuration, a fresh state for each trial (weights from seed
   7): the walk stops at the first batch that runs out of memory
   (`torch.cuda.OutOfMemoryError` only; any other exception goes up, as
   JAX re-raises all but RESOURCE_EXHAUSTED). A trial prints the memory
   live after its step (JAX's figure) and its peak
   (`max_memory_allocated` after a `reset_peak_memory_stats` at its
   start, which JAX could not read per trial). After an out-of-memory the
   trial's tensors are dropped and the allocator's cache emptied.

    python -m maskunet_tpu_torch.tools.remat_ab [batch] [steps] [img]
        [--device cuda|cpu]

The steps are `train_breakdown.make_step_call`'s. A host without CUDA is
refused unless `--device cpu` is given (no memory figures there, and the
walk is as long as the host's memory).
"""

from __future__ import annotations

import argparse
import gc

from maskunet_tpu_torch.tools.fwd_breakdown import device_suffix, interleaved
from maskunet_tpu_torch.tools.train_breakdown import make_step_call

BATCHES = (8, 16, 32, 64, 96, 128, 192, 256)


def _dtype(device: str) -> str:
    import torch
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def step_call(remat: bool, batch: int, img: int, device: str,
              seed: int = 0):
    """The JAX tool's step (AdamW 1e-3 / 1e-4, precomputed plans) as a
    call that returns the loss."""
    from maskunet_tpu_torch.train import loop as loop_lib

    return make_step_call("full", batch, img_size=img, device=device,
                          tx=loop_lib.AdamW(1e-3, 1e-4), mask_plans=True,
                          remat=remat, dtype=_dtype(device), seed=seed)


def trial(remat: bool, batch: int, img: int, device: str) -> dict:
    """One fresh state at `batch` (weights from seed 7) and one step:
    {"live_mb", "peak_mb"} (None on the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step = step_call(remat, batch, img, device, seed=7)
    row = {"loss": float(step()), "live_mb": None, "peak_mb": None}
    if dev.type == "cuda":     # the state is live, as in JAX's figure
        row.update(live_mb=torch.cuda.memory_allocated(dev) / 1e6,
                   peak_mb=torch.cuda.max_memory_allocated(dev) / 1e6)
    return row


def walk(remat: bool, img: int, device: str, batches=BATCHES) -> dict:
    """Trials at `batches` in order until one runs out of memory; returns
    {"fit": (batch, trial row) of the last that fit or None, "oom": the
    batch that did not or None}."""
    import torch

    fit, oom = None, None
    for b in batches:
        try:
            fit = (b, trial(remat, b, img, device))
        except torch.cuda.OutOfMemoryError:
            oom = b
        if oom is not None:
            # the failed trial's tensors went with its frames
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            break
    return {"fit": fit, "oom": oom}


def _mb(x) -> str:
    return "not measured" if x is None else f"{x:.0f} MB"


def run(batch: int = 8, steps: int = 20, img: int = 128, *,
        device: str = "cuda", batches=BATCHES, rounds: int = 2,
        device_calls: int = 3) -> dict:
    """Both parts; prints the JAX tool's lines (with device ms and peak
    MB). Returns {"cost": {...}, "headroom": {name: walk}}."""
    from maskunet_tpu_torch.core.device import resolve_device

    resolve_device(device)
    print(f"device={device} batch={batch} img={img} steps={steps} "
          f"dtype={_dtype(device)}")
    modes = (("plain", False), ("remat", True))
    cost = interleaved({name: step_call(remat, batch, img, device)
                        for name, remat in modes}, float, steps,
                       rounds=rounds, device_calls=device_calls)
    for name, r in cost.items():
        for sec in r["rounds"]:
            print(f"  {name:5s}: {sec * 1e3:7.2f} ms/step "
                  f"({batch / sec:6.1f} img/s)")
        print(f"  {name:5s}:{device_suffix(r['device_ms'])} a step",
              flush=True)
    gc.collect()

    print("max-fitting training batch (fresh state per trial):")
    headroom = {}
    for name, remat in modes:
        w = walk(remat, img, device, batches)
        headroom[name] = w
        if w["oom"] is not None:
            print(f"  {name:5s}: batch {w['oom']} OOM")
        if w["fit"]:
            b_ok, row = w["fit"]
            print(f"  {name:5s}: largest tried-and-fit batch {b_ok}, live "
                  f"{_mb(row['live_mb'])} after step, peak "
                  f"{_mb(row['peak_mb'])}", flush=True)
    return {"cost": cost, "headroom": headroom}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="remat_ab")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("steps", type=int, nargs="?", default=20)
    ap.add_argument("img", type=int, nargs="?", default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("remat_ab", args.device)
    return run(args.batch, args.steps, args.img, device=args.device)


if __name__ == "__main__":
    main()
