"""Micro-benchmark of the masked attention layer on the card.

Counterpart of tools/attn_microbench.py: the whole flash attention layer
(`ops.flash_attention.masked_attention_flash`: the QKV projection, the
key compaction at 4,096 tokens and more, the kernel, the residual and
LayerNorm) at the model's hot shapes, alone, so that a kernel change is
timed in seconds instead of through the whole model:

  (16384, 64)   attn6 at 128 px
  (4096, 64)    attn5
  (4096, 128)   attn1
  (1024, 256)   attn2

    python -m maskunet_tpu_torch.tools.attn_microbench [batch]
        [--device cuda|cpu]

For each shape, bf16, weights, tokens and a Bernoulli(0.5) key mask from
seeds 0-2: the forward (K1, no autograd) and the gradient of
sum(out²) with respect to the tokens (K2 then K4). Wall times are
`fwd_breakdown.timeit`'s best of 3 windows (20 forward calls, 10 gradient
calls, the JAX tool's counts) with the card's kernel time a call
(`utils/profiling.device_ms_per_call`) beside. TF/s counts the two
products over the compacted key slots (`_key_capacity`) where the layer
compacts, as the JAX tool does. JAX prints its block sizes
(MASKUNET_FLASH_BQ/BK); the port prints the body each kernel runs at the
shape's C in its place (`flash_fwd_nomax_body`, `flash_bwd_body`: wgmma
or mma_sync; 'plain' on the CPU). A host without CUDA is refused unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor, timeit)

SHAPES = ((16384, 64), (4096, 64), (4096, 128), (1024, 256))


def layer_inputs(batch: int, l: int, c: int, dev, dtype):
    """(params, tokens, key mask) of one attention layer: weights from seed
    0 in `dtype`, tokens from seed 1, a Bernoulli(0.5) mask from seed 2."""
    import torch

    from maskunet_tpu_torch.ops import attention

    params = {k: v.to(dev, dtype) for k, v in attention.attention_init(
        torch.Generator().manual_seed(0), c).items()}
    gen = torch.Generator(device=dev)
    tokens = torch.randn(batch, l, c, generator=gen.manual_seed(1),
                         device=dev).to(dtype)
    mask = attention.random_key_mask(gen.manual_seed(2), batch, l)
    return params, tokens, mask


def layer_calls(params, tokens, mask):
    """(forward, gradient) of the layer as calls: the forward's output, and
    the gradient of sum(out²) (in f32) with respect to the tokens."""
    import torch

    from maskunet_tpu_torch.ops import flash_attention as fa

    def fwd():
        with torch.no_grad():
            return fa.masked_attention_flash(params, tokens, mask)

    def grad():
        t = tokens.detach().requires_grad_(True)
        out = fa.masked_attention_flash(params, t, mask)
        (g,) = torch.autograd.grad(out.float().square().sum(), t)
        return g

    return fwd, grad


def bodies(c: int, dtype, dev) -> tuple[str, str]:
    """The bodies K1/K2 and K4 run at `c` channels (asks the built
    libraries); 'plain' on the CPU."""
    if dev.type != "cuda":
        return "plain", "plain"
    from maskunet_tpu_torch.ops import flash_kernels as fk
    return fk.flash_fwd_nomax_body(c, dtype), fk.flash_bwd_body(c, dtype)


def run(batch: int = 8, shapes=SHAPES, *, device: str = "cuda",
        fwd_steps: int = 20, grad_steps: int = 10, repeats: int = 3,
        device_calls: int = 3) -> list[dict]:
    """Times each (L, C) of `shapes`; prints the JAX tool's lines with the
    device ms beside. Returns one row a shape."""
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.ops import flash_attention as fa
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    dtype = torch.bfloat16
    print(f"device={dev.type} batch={batch} bf16")
    rows = []
    for l, c in shapes:
        fwd, grad = layer_calls(*layer_inputs(batch, l, c, dev, dtype))
        fwd_ms = timeit(fwd, fence_tensor, steps=fwd_steps,
                        repeats=repeats) * 1e3
        fwd_dev = device_ms_per_call(fwd, calls=device_calls)
        bwd_ms = timeit(grad, fence_tensor, steps=grad_steps,
                        repeats=repeats) * 1e3
        bwd_dev = device_ms_per_call(grad, calls=device_calls)
        lk = fa._key_capacity(l) if l >= fa.COMPACT_MIN_TOKENS else l
        flops = 2 * 2 * batch * l * lk * c
        fwd_body, bwd_body = bodies(c, dtype, dev)
        rows.append({"l": l, "c": c, "lk": lk, "fwd_ms": fwd_ms,
                     "fwd_device_ms": fwd_dev, "fwd_bwd_ms": bwd_ms,
                     "fwd_bwd_device_ms": bwd_dev, "fwd_body": fwd_body,
                     "bwd_body": bwd_body})
        print(f"L={l:6d} C={c:4d} ({fwd_body}/{bwd_body}): fwd "
              f"{fwd_ms:7.2f} ms ({flops / fwd_ms / 1e9:6.1f} TF/s)"
              f"{device_suffix(fwd_dev)}  fwd+bwd {bwd_ms:7.2f} ms"
              f"{device_suffix(bwd_dev)}", flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="attn_microbench")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("attn_microbench", args.device)
    return run(args.batch, device=args.device)


if __name__ == "__main__":
    main()
