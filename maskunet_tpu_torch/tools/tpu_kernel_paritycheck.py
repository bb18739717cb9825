"""On-card parity check: the built flash kernels against dense attention.

Counterpart of tools/tpu_kernel_paritycheck.py, whose name it keeps so that
a reader finds it. The CPU tests run the kernels' plain versions; this tool
holds the kernels built for the card (K1 for the forward, K2 and K4 under
autograd, through `ops/flash_attention.masked_attention_flash`) to
`ops/attention.masked_attention_dense`, forward and gradient, to catch
what only the built kernels get wrong (tiling, the TMA maps' edges, the
reductions).

    python -m maskunet_tpu_torch.tools.tpu_kernel_paritycheck
        [--device cuda|cpu]

Notes, as the JAX tool's:
- f32 is exact f32 (no TF32, `core/device.exact_f32`): TF32 would round
  the dense and flash paths differently and hide a real fault in that
  shared approximation (JAX sets float32 matmul precision for this).
- The loss is a random projection, sum(out * w): sum(LN(out)^2) is nearly
  independent of the input and would turn 1e-6 of noise into misleading
  relative numbers.
- The dense reference holds L x L scores, so the shapes checked against
  it stop at 4,096 tokens; `check_16k` checks the 16,384-token layer,
  which takes the compacted `use_valid=False` path, against
  `dense_chunked`, which takes the queries 2,048 at a time.

The gate is the JAX tool's: forward max|Δ| < 1e-4, gradient max|Δ| <
1e-4 * (1 + max|grad|). On the card every shape must also launch K1, K2
and K4: a plain path that ran in their place fails. A host without CUDA
is refused unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

SHAPES = ((1024, 64, 2), (2048, 64, 2), (4096, 64, 2), (4096, 128, 2))
TOL = 1e-4


def inputs(l: int, c: int, b: int, device):
    """The attention params, tokens [b, l, c], key mask [b, l] and the
    loss projection w [c], from seeds 0-3 on the CPU, then on `device`."""
    import torch

    from maskunet_tpu_torch.ops import attention

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    params = {k: v.to(device)
              for k, v in attention.attention_init(gen(0), c).items()}
    tokens = torch.randn(b, l, c, generator=gen(1)).to(device)
    mask = attention.random_key_mask(gen(2), b, l).to(device)
    w = torch.randn(c, generator=gen(3)).to(device)
    return params, tokens, mask, w


def dense_chunked(params, tokens, mask, chunk: int = 2048):
    """Dense attention that never holds the whole [L, L] scores: the
    queries `chunk` rows at a time, each chunk against every key (so the
    softmax is exact). Mathematically `attention.masked_attention_dense`;
    the JAX tool's `dense_chunked`."""
    import torch

    from maskunet_tpu_torch.core import layers

    c = tokens.shape[-1]
    q = layers.linear(params["query.weight"], params["query.bias"],
                      tokens) / (c ** 0.5)
    k = layers.linear(params["key.weight"], params["key.bias"], tokens)
    v = layers.linear(params["value.weight"], params["value.bias"], tokens)
    visible = mask[:, None, :]
    outs = []
    for qi in q.split(chunk, dim=1):
        s = torch.einsum("bqc,bkc->bqk", qi.float(), k.float())
        s = torch.where(visible, s, -1e30)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m.detach())
        e = torch.where(visible, e, 0.0)
        wts = (e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
               ).to(tokens.dtype)
        outs.append(torch.einsum("bqk,bkc->bqc", wts.float(), v.float()
                                 ).to(tokens.dtype))
    out = torch.cat(outs, dim=1) + tokens
    return layers.layernorm(params["norm.weight"], params["norm.bias"], out)


def check(l: int, c: int, b: int, *, device: str = "cuda",
          reference=None, note: str = "") -> dict:
    """The flash path against `reference` (dense attention by default) at
    one shape: forward without gradient, then the gradient of sum(out * w)
    with respect to the tokens. Prints the JAX tool's line; returns the
    errors, the gate's verdict and the flash kernels' launches."""
    import torch

    from maskunet_tpu_torch.core.device import exact_f32, resolve_device
    from maskunet_tpu_torch.ops import attention, flash_attention
    from maskunet_tpu_torch.ops import flash_kernels as fk

    dev = resolve_device(device)
    exact_f32()
    reference = reference or attention.masked_attention_dense
    flash_fn = flash_attention.masked_attention_flash
    params, tokens, mask, w = inputs(l, c, b, dev)
    kernels = {"K1": fk.flash_fwd_nomax, "K2": fk.flash_fwd_nomax_lse,
               "K4": fk.flash_bwd}

    def grad(fn):
        t = tokens.clone().requires_grad_(True)
        return torch.autograd.grad((fn(params, t, mask) * w).sum(), t)[0]

    with torch.no_grad():
        dense = reference(params, tokens, mask)
    before = {k: fn.launches for k, fn in kernels.items()}
    with torch.no_grad():
        flash = flash_fn(params, tokens, mask)
    fwd_err = float((dense - flash).abs().max())

    gd = grad(reference)
    gf = grad(flash_fn)
    launches = {k: fn.launches - before[k] for k, fn in kernels.items()}
    gscale = float(gd.abs().max())
    grad_err = float((gd - gf).abs().max())
    launched = dev.type != "cuda" or all(launches.values())
    ok = fwd_err < TOL and grad_err < TOL * (1.0 + gscale) and launched
    print(f"L={l:6d} C={c:4d}: fwd max|Δ| {fwd_err:.2e} "
          f"grad max|Δ| {grad_err:.2e} (scale {gscale:.2e}) "
          f"{'OK' if ok else 'FAIL'}{note}", flush=True)
    if not launched:
        print(f"  the kernels did not launch: {launches}", flush=True)
    return {"l": l, "c": c, "b": b, "fwd_err": fwd_err,
            "grad_err": grad_err, "grad_scale": gscale, "ok": ok,
            "launches": launches}


def check_16k(*, device: str = "cuda", l: int = 16384, c: int = 64,
              chunk: int = 2048) -> dict:
    """The compacted 16,384-token layer (forward and gradient) against
    `dense_chunked`: at this size the model takes the compacted
    `use_valid=False` path, and so does this check (batch 1: the dense
    chunks are ~134 MB of f32)."""
    import functools

    from maskunet_tpu_torch.ops import flash_attention

    assert l >= flash_attention.COMPACT_MIN_TOKENS   # compaction engages
    return check(l, c, 1, device=device,
                 reference=functools.partial(dense_chunked, chunk=chunk),
                 note=" [compacted use_valid=False path]")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="tpu_kernel_paritycheck")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("tpu_kernel_paritycheck", args.device)
    rows = [check(l, c, b, device=args.device) for l, c, b in SHAPES]
    rows.append(check_16k(device=args.device))
    failures = sum(not r["ok"] for r in rows)
    if failures:
        raise SystemExit(f"{failures} parity failures")
    print("all compiled-kernel parity checks passed")
    return rows


if __name__ == "__main__":
    main()
