"""Batched bf16 matmuls at C 64 against C 128, on the card.

Counterpart of tools/lane_ab.py. The JAX tool asks whether the TPU's
matrix unit is half used at the model's narrowest width, C 64 (attn5
and attn6), and whether packing two batch rows into one 128-wide
contraction could recover it. On Hopper the question changes shape:

1. **The tensor core has no 128-wide lane to fill.** A warpgroup's
   wgmma is m64nNk16: 64 rows, N from 8 to 256 in steps of 8, and a
   contraction of 16 a step in bf16. QKᵀ at C 64 is four k-steps a tile
   and at C 128 eight; P·V's output has N = C, 64 or 128, both legal
   tile widths. Nothing in the instruction is padded at C 64, so there
   is no underfill for packing to recover.
2. **Packing would still cost.** Two batch rows in one contraction
   need block-diagonal zero padding: for QKᵀ, q' = [q_b0 | q_b1]
   ([BQ, 128]) against K' = [[k_b0, 0], [0, k_b1]] ([2BK, 128]): BQ x 2BK
   x 128 MACs where the two C 64 products do 2 x BQ x BK x 64, twice the
   work; for P·V four times. On a unit that is not underfilled that is a
   straight loss.
3. **What the matmuls here measure.** B 8, L 8,192: QKᵀ writes, and P·V
   reads, an [L, L] bf16 operand of 8 x 8,192² x 2 bytes = 1.07 GB a
   call, at either C. At the H100's 3.35 TB/s (spec) that is ~0.32 ms,
   against ~0.07 (C 64) and ~0.14 ms (C 128) of products at 989 TF/s
   dense bf16 (spec). So these library matmuls are bound by that
   operand's bytes at both widths, and C 64 shows about half C 128's
   TF/s in about the same time for that reason. The flash kernels never
   write [L, L]; their own bounds are in PERF.md §6.

    python -m maskunet_tpu_torch.tools.lane_ab [--device cuda|cpu]

Timed with `torch.bmm` (cuBLAS; the JAX tool measures XLA's matmul
likewise, outside any Pallas kernel), best of 3 windows of 30 calls
(`fwd_breakdown.timeit`), with the card's kernel time a call beside
(`utils/profiling.device_ms_per_call`). A host without CUDA is refused
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor, timeit)


def cases(l: int) -> tuple:
    """(label, m, k, n) of the four products at L = `l`."""
    return (("QK^T  C=64 ", l, 64, l), ("QK^T  C=128", l, 128, l),
            ("PV    C=64 ", l, l, 64), ("PV    C=128", l, l, 128))


def run(*, l: int = 8192, b: int = 8, device: str = "cuda",
        iters: int = 30, device_calls: int = 3) -> dict:
    """Times the four products; prints the JAX tool's lines with the
    device ms and TF/s. Returns {label: {"ms", "tflops", "device_ms"}}."""
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"batched matmul timings, B={b}, L={l}, bf16 "
          f"(3 trials x {iters} iters, best):")
    res = {}
    for label, m, k, n in cases(l):
        x = torch.randn(b, m, k, generator=gen, device=dev).bfloat16()
        y = torch.randn(b, k, n, generator=gen, device=dev).bfloat16()

        def f():
            return torch.bmm(x, y)

        dt = timeit(f, fence_tensor, steps=iters)
        dev_ms = device_ms_per_call(f, calls=device_calls)
        flops = 2 * b * m * k * n
        res[label.strip()] = {"ms": dt * 1e3, "tflops": flops / dt / 1e12,
                              "device_ms": dev_ms}
        dev_tf = ("" if dev_ms is None
                  else f" ({flops / dev_ms / 1e9:6.1f} TF/s)")
        print(f"  {label}: {dt * 1e3:7.3f} ms  {flops / dt / 1e12:6.1f} TF/s"
              f"{device_suffix(dev_ms)}{dev_tf}", flush=True)
        del x, y
    print("\nInterpretation: on Hopper the C=64 rows are no half-filled "
          "tensor core (wgmma takes N = 64 and contracts 16 a step); if "
          "they run at ~half the C=128 TF/s in about the same time, the "
          "[L, L] operand's bytes set that time at both widths (see the "
          "docstring), and no batch-row packing can help: it only adds "
          "MACs.")
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="lane_ab")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("lane_ab", args.device)
    return run(device=args.device)


if __name__ == "__main__":
    main()
