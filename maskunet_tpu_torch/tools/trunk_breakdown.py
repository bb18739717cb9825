"""Conv-trunk ablation: what the forward without attention is made of.

Counterpart of tools/trunk_breakdown.py. With the attention dispatch the
identity, it patches single layer ops (`core.layers.gelu`, `.layernorm`,
`.upsample_2x_bilinear`) to the identity or a cheaper variant and times
the forward of each variant in one process (same-process A/B).

    python -m maskunet_tpu_torch.tools.trunk_breakdown [batch]
        [--device cuda|cpu]

The model is `fwd_breakdown`'s (the JAX tool's inference forward), and so
are the timer (best of 3 windows of 30 calls), the patches' restore and
the device ms beside each wall time. A host without CUDA is refused
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor,
                                                    inference_setup,
                                                    make_forward, patched,
                                                    timeit)

VARIANTS = ("trunk", "no_gelu", "tanh_gelu", "no_layernorm", "nearest_up")


def variant_patches(name: str) -> list:
    """(module, name, value) patches of a variant: the attention dispatch
    as the identity, and the layer op the variant replaces."""
    import torch.nn.functional as F

    from maskunet_tpu_torch.core import layers
    from maskunet_tpu_torch.ops import attention

    ops = {
        "trunk": {},
        "no_gelu": {"gelu": lambda x: x},
        "tanh_gelu": {"gelu": lambda x: F.gelu(x, approximate="tanh")},
        "no_layernorm": {"layernorm": lambda w, b, x, **kw: x},
        "nearest_up": {"upsample_2x_bilinear":
                       lambda x: x.repeat_interleave(2, 1)
                       .repeat_interleave(2, 2)},
    }[name]
    return ([(attention, "spatial_attention", lambda p, xx, km, **kw: xx)]
            + [(layers, op, fn) for op, fn in ops.items()])


def run(batch: int = 8, variants=VARIANTS, *, steps: int = 30,
        repeats: int = 3, device_calls: int = 3, img_size: int = 128,
        device: str = "cuda") -> dict:
    """Times each variant's forward; prints the JAX tool's lines with the
    device ms beside. Returns {variant: {"ms", "device_ms", "mean"}}."""
    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    fwd = make_forward(*inference_setup(batch, img_size, dev))
    results = {}
    for name in variants:
        with patched(*variant_patches(name)):
            mean = float(fwd().float().mean())
            sec = timeit(fwd, fence_tensor, steps=steps, repeats=repeats)
            dev_ms = device_ms_per_call(fwd, calls=device_calls)
        results[name] = {"ms": sec * 1e3, "device_ms": dev_ms, "mean": mean}
        print(f"{name:14s} {sec * 1e3:7.2f} ms  (out mean {mean:.4f})"
              f"{device_suffix(dev_ms)}", flush=True)

    base = results.get(variants[0])
    for name in list(results)[1:]:
        r = results[name]
        d_dev = (None if r["device_ms"] is None or base["device_ms"] is None
                 else base["device_ms"] - r["device_ms"])
        print(f"{name:14s} delta {base['ms'] - r['ms']:+6.2f} ms"
              f"{device_suffix(d_dev)}")
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="trunk_breakdown")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("trunk_breakdown", args.device)
    return run(args.batch, device=args.device)


if __name__ == "__main__":
    main()
