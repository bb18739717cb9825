"""Forward variants of K1 at attn6, as a whole layer, and the compaction
cost, on the card.

Counterpart of tools/fwd_sweep.py. The JAX tool re-sweeps the Pallas
kernel's block sizes; the port's kernel has no block-size knob, but
`fwd_ab` builds variants of its source (ring depth, keys a step,
warpgroups, ping-pong, producer, body), one text substitution each. This
tool times them where the model runs them:

1. The whole attn6 layer (16,384 tokens, C 64, batch 8, bf16: the QKV
   projection, the compaction to 9,216 key slots, K1, the residual and
   LayerNorm) for each variant named by `--variants` (default: every
   variant of `fwd_ab` that changes the C 64 kernel). Each variant's
   library is built by `fwd_ab._build` from `fwd_ab.variants`, and the
   layer reaches it through `ops.flash_kernels._entry`, the wrappers'
   lookup of a C entry, patched for the variant's timing
   (`fwd_breakdown.patched`). The `source` row goes through the same
   patch, with the committed library's entries (no build).
2. The compaction's cost: `compact_keys` (the plan's cumsum and scatter,
   then the K/V gathers) against the gathers alone from a precomputed
   plan; the difference is paid by three layers a step when the plan is
   not precomputed.

    python -m maskunet_tpu_torch.tools.fwd_sweep [batch]
        [--variants source,keys64,...] [--device cuda|cpu]

Wall times are `fwd_breakdown.timeit`'s (best of 3 windows of 30 calls),
with the card's kernel time a call (`utils/profiling.device_ms_per_call`)
beside. On the CPU (`--device cpu`) no variant can be built: part 1 times
the plain version as `source` only.
"""

from __future__ import annotations

import argparse
import contextlib

from maskunet_tpu_torch.tools.attn_microbench import layer_calls, layer_inputs
from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor, patched,
                                                    timeit)

ATTN6 = (16384, 64)
# fwd_ab's variants of the nomax source that change its C 64 kernel
C64_VARIANTS = ("source", "mma_sync", "producer0", "pingpong", "stages2",
                "stages3", "keys64", "keys256", "wg3")
# the C entries a variant swaps in: K1's (the eval forward)
_ENTRIES = ("flash_fwd_nomax",)


def entry_swap(fns: dict):
    """A patch of `flash_kernels._entry` that returns `fns[name]` for the
    entries in `fns` and the committed library's for the others."""
    from maskunet_tpu_torch.ops import flash_kernels as fk

    orig = fk._entry
    return patched((fk, "_entry", lambda name: fns.get(name) or orig(name)))


def built_entries(names, builder, entries) -> dict:
    """{variant: {entry: C function}}: `source` the committed library's
    `entries`, the other variants from `builder(names)` ({variant:
    {entry: C function}}, built at once)."""
    from maskunet_tpu_torch.ops import flash_kernels as fk

    others = [n for n in names if n != "source"]
    out = builder(others) if others else {}
    out["source"] = {e: fk._entry(e) for e in entries}
    return {n: out[n] for n in names}


def _build_fwd(names) -> dict:
    from maskunet_tpu_torch.ops import flash_kernels as fk
    from maskunet_tpu_torch.tools import fwd_ab

    src = fk.SOURCES["flash_fwd_nomax"].read_text()
    return {name: fns for name, (fns, _) in fwd_ab._build(
        fwd_ab.variants(src, names), "nomax").items()}


def run(batch: int = 8, variants=C64_VARIANTS, *, shape=ATTN6,
        device: str = "cuda", steps: int = 30, repeats: int = 3,
        device_calls: int = 3) -> dict:
    """Part 1 for each variant, then part 2, at `shape` (L, C); prints the
    lines and returns {"layer": {variant: {"ms", "device_ms"}},
    "compaction": {...}}."""
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.ops import flash_attention as fa
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    dtype = torch.bfloat16
    l, c = shape
    print(f"device={dev.type} batch={batch} bf16")
    if dev.type == "cuda":
        swaps = {n: entry_swap(fns) for n, fns in built_entries(
            variants, _build_fwd, _ENTRIES).items()}
    else:
        print("variants are built for the card: the CPU times the plain "
              "version as source")
        swaps = {"source": contextlib.nullcontext()}
    params, tokens, mask = layer_inputs(batch, l, c, dev, dtype)
    fwd, _ = layer_calls(params, tokens, mask)
    layer = {}
    for name, swap in swaps.items():
        with swap:
            sec = timeit(fwd, fence_tensor, steps=steps, repeats=repeats)
            dev_ms = device_ms_per_call(fwd, calls=device_calls)
        layer[name] = {"ms": sec * 1e3, "device_ms": dev_ms}
        print(f"fwd L={l} C={c} {name:10s}: {sec * 1e3:7.3f} ms"
              f"{device_suffix(dev_ms)}", flush=True)

    # ---- compaction cost: full compact_keys vs gather-from-plan
    gen = torch.Generator(device=dev)
    ks = torch.randn(batch, l, c, generator=gen.manual_seed(3),
                     device=dev).to(dtype)
    vs = torch.randn(batch, l, c, generator=gen.manual_seed(4),
                     device=dev).to(dtype)
    idx = fa.plan_compaction(mask).idx[..., None].expand(-1, -1, c)

    def full():
        return fa.compact_keys(ks, vs, mask)[0]

    def gather_only():
        torch.gather(vs, 1, idx)
        return torch.gather(ks, 1, idx)

    t_full = timeit(full, fence_tensor, steps=steps, repeats=repeats) * 1e3
    d_full = device_ms_per_call(full, calls=device_calls)
    t_gather = timeit(gather_only, fence_tensor, steps=steps,
                      repeats=repeats) * 1e3
    d_gather = device_ms_per_call(gather_only, calls=device_calls)
    d_over = None if d_full is None or d_gather is None else d_full - d_gather
    print(f"compact_keys full: {t_full:7.3f} ms   "
          f"gather-from-plan: {t_gather:7.3f} ms   "
          f"plan overhead: {t_full - t_gather:7.3f} ms (x3 layers/step)")
    print(f"  device: full{device_suffix(d_full)}  gather"
          f"{device_suffix(d_gather)}  overhead{device_suffix(d_over)}")
    return {"layer": layer,
            "compaction": {"full_ms": t_full, "gather_ms": t_gather,
                           "full_device_ms": d_full,
                           "gather_device_ms": d_gather}}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="fwd_sweep")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--variants", default=",".join(C64_VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("fwd_sweep", args.device)
    return run(args.batch, tuple(args.variants.split(",")),
               device=args.device)


if __name__ == "__main__":
    main()
