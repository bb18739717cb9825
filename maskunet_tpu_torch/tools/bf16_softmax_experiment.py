"""bf16 scores and probabilities inside the online-max forward, on the card.
Counterpart of tools/bf16_softmax_experiment.py, with its kernel:

- K7 `flash_fwd_bf16`: the JAX tool's `_fwd_kernel_bf16`
  (tools/bf16_softmax_experiment.py:32-71), an online-max forward with
  natural exp whose scores, running max and p are bf16; CUDA in
  csrc/flash_fwd_online.cu (entry `flash_fwd_online_bf16`, on K3's body
  at C = 64: `flash_kernels.flash_fwd_online_body(64, ...)`). bf16 at C =
  64 only, the instantiation the tool launches; anything else raises. A CPU
  tensor runs the plain version, a CUDA tensor the kernel, counted in
  `flash_fwd_bf16.launches`.

The tool times K7 against the serving forward (`flash_mha` without a
gradient: K1, or K3 under MASKUNET_SAFE_SOFTMAX=1) at attn6 of the ADE
model at batch 8 (16,384 queries, C 64, a Bernoulli(0.5) key mask compacted
to 9,216 slots, bf16 q ~ N(0, 1) / 8), and prints K7's deviation from it.
Times are CUDA events after a warm-up, the minimum over 3 windows of 30
calls, the two taking turns.

    python -m maskunet_tpu_torch.tools.bf16_softmax_experiment
"""

from __future__ import annotations

import torch

from maskunet_tpu_torch.core.layers import weak_scalar
from maskunet_tpu_torch.ops import attention
from maskunet_tpu_torch.ops import flash_attention as fa
from maskunet_tpu_torch.ops import flash_kernels as fk
from maskunet_tpu_torch.tools.softmax_ab import (need_card, check_bf16_c64,
                                                 min_window_ms)


# keys a tile of the CUDA kernel: its key step at C = 64 (`kKeys64` in
# csrc/flash_fwd_online.cu), which K7's result depends on
BLOCK_K = 128


def flash_fwd_bf16_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             block_k: int | None = BLOCK_K):
    """Plain version of K7: (o in q's dtype, lse [B, 1, Lq] f32), rounding
    where the TPU kernel does, key tile by key tile of `block_k` keys (None:
    one tile). s = bf16(q k^T) + bf16(bias) in bf16; the running max m_t =
    max(bf16(-1e30), max of s over tiles <= t) in bf16 (NaN kept); p =
    exp(s - m_t) with s - m_t and p in bf16; each tile's sums are carried
    to the end by alpha = exp(f32(bf16(m_{t-1} - m_t))) per later tile; l
    the f32 sum of the bf16 p, o = (p . v) / max(l, 1e-30), lse = f32(m) +
    ln(max(l, 1e-30)). A fully masked row gives the mean of V. The tiles
    matter here: p rounds to bf16 relative to the running max, so another
    tiling moves lse by up to a few bf16 steps of p. (torch computes bf16
    elementwise operations in f32 and rounds once, as XLA does.)"""
    lq, lk = q.shape[1], k.shape[1]
    bk = lk if block_k is None else block_k
    nt = -(-lk // bk)
    tile = torch.arange(lk, device=q.device) // bk
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], 1, lq, device=q.device)
    floor = torch.tensor(fk.NEG_INF, dtype=torch.bfloat16, device=q.device)
    for i in range(q.shape[0]):
        s = torch.matmul(q[i].float(), k[i].float().transpose(0, 1))
        s = s.bfloat16() + bias[i].bfloat16()
        padded = torch.nn.functional.pad(s, (0, nt * bk - lk),
                                         value=float("-inf"))
        m = torch.maximum(torch.cummax(padded.view(lq, nt, bk).amax(-1),
                                       dim=1).values, floor)  # [Lq, nt]
        p = torch.exp(s - m[:, tile])
        prev = torch.cat([floor.expand(lq, 1), m[:, :-1]], dim=1)
        alpha = torch.exp((prev - m).float())
        # tile t's weight at the end: the product of the later tiles' alpha
        carry = torch.cat([alpha[:, 1:], torch.ones_like(alpha[:, :1])], 1)
        carry = torch.flip(torch.cumprod(torch.flip(carry, [1]), 1), [1])
        pw = p.float() * carry[:, tile]
        l = torch.clamp(pw.sum(dim=-1, keepdim=True), min=1e-30)
        acc = torch.matmul(pw, v[i].float())
        out[i] = (acc / l).to(q.dtype)
        lse[i, 0] = (m[:, -1:].float() + torch.log(l))[:, 0]
    return out, lse


def flash_fwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 on q, k, v [B, L, 64] bf16 (q as given, no scale) and bias
    [B, 1, Lk] f32: (o, lse)."""
    check_bf16_c64("flash_fwd_bf16", q, v)
    if not fk._on_card(q):
        return flash_fwd_bf16_reference(q, k, v, bias)
    fk._check(q, k, v, bias)
    b, lq, c = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, 1, lq, device=q.device)
    flash_fwd_bf16.launches += fk._launch_batched(
        "flash_fwd_online_bf16", (q, k, v, bias, o, lse), lq, k.shape[1], c)
    return o, lse


flash_fwd_bf16.launches = 0


def attn6_inputs(batch: int = 8, device="cuda", seed: int = 0):
    """The JAX tool's inputs, drawn with torch: q, k (compacted), v
    (compacted) and the compacted bias at 16,384 tokens, C 64."""
    gen = torch.Generator(device=device).manual_seed(seed)
    l, c = 16384, 64
    q = torch.randn(batch, l, c, generator=gen, device=device).bfloat16() \
        * weak_scalar(0.125, torch.bfloat16)
    mask = attention.random_key_mask(gen, batch, l)
    k, v = (torch.randn(batch, l, c, generator=gen, device=device).bfloat16()
            for _ in range(2))
    k_c, v_c, valid = fa.compact_keys(k, v, mask)
    return q, k_c, v_c, fa.mask_to_bias(valid, batch, k_c.shape[1])


def main() -> dict:
    """Times and deviation of K7 against the serving forward; returns the
    printed numbers."""
    need_card("bf16_softmax_experiment")
    q, k, v, bias = attn6_inputs()

    def cur():
        with torch.no_grad():
            return fa.flash_mha(q, k, v, bias, 1.0, False)

    fns = {"f32-softmax": cur,
           "bf16-softmax": lambda: flash_fwd_bf16(q, k, v, bias)[0]}
    best = min_window_ms(fns)
    o_cur, o_new = cur().float(), fns["bf16-softmax"]().float()
    scale = float(o_cur.abs().max())
    dev = float((o_new - o_cur).abs().max())
    t_cur, t_new = best["f32-softmax"], best["bf16-softmax"]
    print(f"device={torch.cuda.get_device_name(0)} batch={q.shape[0]} "
          f"safe_softmax={fa._SAFE_SOFTMAX}", flush=True)
    print(f"f32-softmax kernel: {t_cur:.3f} ms", flush=True)
    print(f"bf16-softmax kernel: {t_new:.3f} ms "
          f"(speedup {t_cur / t_new:.3f}x)", flush=True)
    print(f"max |delta| {dev:.2e} (output scale {scale:.2e}, "
          f"rel {dev / scale:.2e})", flush=True)
    return {"ms": best, "max_abs_delta": dev, "output_scale": scale}


if __name__ == "__main__":
    main()
