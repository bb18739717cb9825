"""Same-process A/B: precomputed compaction plans against planning in
each call, on the card.

Counterpart of tools/plan_ab.py. The attention key masks are drawn once
and cached for the whole run (the reference's semantics), so the
compaction plan of each compacted layer (`plan_compaction`: a cumsum and
a scatter over each mask) can be computed once
(`precompute_mask_plans`) instead of in every forward and step. This
times both, for the serving forward (BN folded, bf16-cast) and the train
step (AdamW 5e-5 / 0.1), at the ADE model (c_out 150, 128 px, batch 8,
bf16), in JAX's two interleaved rounds (inline, plan, inline, plan),
whose means are printed.

    python -m maskunet_tpu_torch.tools.plan_ab [batch] [steps]
        [--device cuda|cpu]

Each round is one `fwd_breakdown.timeit` window of `steps` calls after a
warm-up call (the step: `train_breakdown.make_step_call`); the card's
kernel time a call (`utils/profiling.device_ms_per_call`) is printed
beside each mean. A host without CUDA is refused unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor,
                                                    inference_setup,
                                                    interleaved,
                                                    make_forward)
from maskunet_tpu_torch.tools.train_breakdown import make_step_call


def _line(what: str, res: dict, batch: int) -> None:
    ti, tp = res["inline"]["ms"], res["plan"]["ms"]
    print(f"{what:8s} inline {ti:7.3f} ms   plan {tp:7.3f} ms   "
          f"{ti / tp:5.3f}x   ({batch / tp * 1e3:.1f} img/s planned)")
    print(f"         inline{device_suffix(res['inline']['device_ms'])}  "
          f"plan{device_suffix(res['plan']['device_ms'])}", flush=True)


def run(batch: int = 8, steps: int = 30, *, img_size: int = 128,
        device: str = "cuda", rounds: int = 2,
        device_calls: int = 3) -> dict:
    """Both A/Bs; prints the JAX tool's two lines with device ms.
    Returns {"forward": {...}, "train": {...}}."""
    from maskunet_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    cfg, p_fold, x, masks, plans = inference_setup(batch, img_size, dev)
    fwd = interleaved({"inline": make_forward(cfg, p_fold, x, masks, None),
                       "plan": make_forward(cfg, p_fold, x, masks, plans)},
                      fence_tensor, steps, rounds=rounds,
                      device_calls=device_calls)
    _line("forward", fwd, batch)
    train = interleaved(
        {name: make_step_call("full", batch, img_size=img_size,
                              device=device, mask_plans=planned)
         for name, planned in (("inline", False), ("plan", True))},
        float, steps, rounds=rounds, device_calls=device_calls)
    _line("train", train, batch)
    return {"forward": fwd, "train": train}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="plan_ab")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("steps", type=int, nargs="?", default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("plan_ab", args.device)
    return run(args.batch, args.steps, device=args.device)


if __name__ == "__main__":
    main()
