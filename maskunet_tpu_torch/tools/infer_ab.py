"""Same-process A/B of the inference forward: eval BatchNorm against BN
folded into the convs, on the card.

Counterpart of tools/infer_ab.py: the ADE model (c_out 150, 128 px,
batch 8, bf16, weights from seed 0, cached masks from seed 1 with their
compaction plans), its eval forward with the BatchNorms applied from
their running statistics against the forward of
`fold_bn_for_inference`'s params, both cast by
`cast_params_for_inference`. One process, one warm-up regime: separate
runs differ by more than the effect under test.

    python -m maskunet_tpu_torch.tools.infer_ab [batch] [--device cuda|cpu]

Wall times are `fwd_breakdown.timeit`'s (best of 3 windows of 30
calls); the card's kernel time a call (`utils/profiling.
device_ms_per_call`) is printed beside: the eager forward at 128 px is
host-bound. A host without CUDA is refused unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor,
                                                    inference_setup,
                                                    init_model, make_forward,
                                                    timeit)


def run(batch: int = 8, *, img_size: int = 128, device: str = "cuda",
        steps: int = 30, repeats: int = 3, device_calls: int = 3) -> dict:
    """Times both forwards; prints the JAX tool's line and the device ms.
    Returns {"plain": {"ms", "device_ms"}, "folded": {...}, "speedup"}."""
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    cfg, p_fold, x, masks, plans = inference_setup(batch, img_size, dev)
    params, mstate = init_model(cfg, dev)
    with torch.no_grad():
        p_plain = mu.cast_params_for_inference(params)
    fwds = {"plain": make_forward(cfg, p_plain, x, masks, plans, mstate),
            "folded": make_forward(cfg, p_fold, x, masks, plans)}
    res = {}
    for name, fwd in fwds.items():
        sec = timeit(fwd, fence_tensor, steps=steps, repeats=repeats)
        res[name] = {"ms": sec * 1e3,
                     "device_ms": device_ms_per_call(fwd, calls=device_calls)}
    t_plain, t_fold = res["plain"]["ms"] / 1e3, res["folded"]["ms"] / 1e3
    res["speedup"] = t_plain / t_fold
    print(f"batch={batch} plain={t_plain * 1e3:.2f} ms "
          f"({batch / t_plain:.1f} img/s)  "
          f"folded={t_fold * 1e3:.2f} ms ({batch / t_fold:.1f} img/s)  "
          f"speedup={t_plain / t_fold:.3f}x")
    print(f"  plain{device_suffix(res['plain']['device_ms'])}  folded"
          f"{device_suffix(res['folded']['device_ms'])}")
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="infer_ab")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("infer_ab", args.device)
    return run(args.batch, device=args.device)


if __name__ == "__main__":
    main()
