"""Backward variants of K4 as the gradient of a whole layer, on the card.

Counterpart of tools/bwd_sweep.py. The JAX tool sweeps the merged
backward's block sizes and a bf16 dQ-partials stream; the port's K4 has
no block-size knob, but `bwd_ab` builds variants of its source (ring
depth, warpgroups, dQ by atomics, the mma.sync body), one text
substitution each. This tool times the gradient of sum(out²) through the
whole layer (`masked_attention_flash`: the QKV projection, compaction,
K2, K4, the epilogue) at attn6 (16,384 tokens, C 64) and attn1/5 (4,096,
C 64), batch 8, bf16, for each variant named by `--variants` (default:
every variant of `bwd_ab`). A variant's library is built by
`bwd_ab._build` from `bwd_ab.variants`, and the wrapper reaches it
through `ops.flash_kernels._entry`, patched for the variant's timing
(`fwd_sweep.entry_swap`); the `source` row goes through the same patch
with the committed library's entry (no build). K2 stays the committed
kernel in every row.

JAX's `pbf16` rows have no counterpart: K4 reduces dQ in f32 by bulk
tensor adds (`csrc/flash_bwd.cu`) and has no partials stream to store in
bf16. The tool prints that row as not applicable, with this reason.

    python -m maskunet_tpu_torch.tools.bwd_sweep [batch]
        [--variants source,atomics,...] [--device cuda|cpu]

Wall times are `fwd_breakdown.timeit`'s (best of 3 windows of 10
gradients, the JAX tool's counts) with the card's kernel time a call
(`utils/profiling.device_ms_per_call`) beside. On the CPU (`--device
cpu`) no variant can be built: the plain version is timed as `source`.
"""

from __future__ import annotations

import argparse
import contextlib

from maskunet_tpu_torch.tools.attn_microbench import layer_calls, layer_inputs
from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor, timeit)
from maskunet_tpu_torch.tools.fwd_sweep import built_entries, entry_swap

SHAPES = {"attn6": (16384, 64), "attn1/5": (4096, 64)}
VARIANTS = ("source", "mma_sync", "atomics", "stages2", "wg1", "wg2")
PBF16_NOTE = ("pbf16: not applicable (K4 reduces dQ in f32 by bulk tensor "
              "adds and has no partials stream to store in bf16)")


def _build_bwd(names) -> dict:
    from maskunet_tpu_torch.ops import flash_kernels as fk
    from maskunet_tpu_torch.tools import bwd_ab

    texts = bwd_ab.variants(fk.SOURCES["flash_bwd"].read_text())
    return {name: {"flash_bwd": fn} for name, (fn, _) in bwd_ab._build(
        {n: texts[n] for n in names}).items()}


def run(batch: int = 8, variants=VARIANTS, *, shapes=SHAPES,
        device: str = "cuda", steps: int = 10, repeats: int = 3,
        device_calls: int = 3) -> dict:
    """Times the layer's gradient at each shape for each variant; prints a
    line a variant and returns {variant: {label: {"ms", "device_ms"}}};
    `shapes`: {label: (L, C)}."""
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    print(f"device={dev.type} batch={batch} bf16")
    if dev.type == "cuda":
        swaps = {n: entry_swap(fns) for n, fns in built_entries(
            variants, _build_bwd, ("flash_bwd",)).items()}
    else:
        print("variants are built for the card: the CPU times the plain "
              "version as source")
        swaps = {"source": contextlib.nullcontext()}
    grads = {label: layer_calls(*layer_inputs(
        batch, l, c, dev, torch.bfloat16))[1]
        for label, (l, c) in shapes.items()}
    out = {}
    for name, swap in swaps.items():
        row = {}
        with swap:
            for label, grad in grads.items():
                sec = timeit(grad, fence_tensor, steps=steps,
                             repeats=repeats)
                row[label] = {"ms": sec * 1e3,
                              "device_ms": device_ms_per_call(
                                  grad, calls=device_calls)}
        out[name] = row
        print(f"{name:10s}: " + "  ".join(
            f"{label} {r['ms']:7.3f} ms{device_suffix(r['device_ms'])}"
            for label, r in row.items()), flush=True)
    print(PBF16_NOTE)
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="bwd_sweep")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("bwd_sweep", args.device)
    return run(args.batch, tuple(args.variants.split(",")),
               device=args.device)


if __name__ == "__main__":
    main()
