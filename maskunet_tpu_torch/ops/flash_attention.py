"""Flash masked attention: the glue around the flash kernels.

Counterpart of maskunet_tpu/ops/flash_attention.py. The key mask enters as
an additive f32 bias [B, 1, Lk] in {0, NEG_INF}. Layers with at least
`COMPACT_MIN_TOKENS` tokens first gather the visible keys into a buffer of
`_key_capacity` slots (a Bernoulli(0.5) mask keeps about half), which
halves the kernel's work; a row with more visible keys than slots, or with
none, is NaN-poisoned so a wrong answer is loud.

`flash_mha` mirrors the JAX custom VJP (flash_attention.py:446-474): with
no gradient to take it runs K1 (`flash_fwd_nomax`); under autograd it runs
`_FlashMHA`, whose forward is K2 (`flash_fwd_nomax_lse`) and whose backward
is K4 (`flash_bwd`) with its clamp at 2^60. MASKUNET_SAFE_SOFTMAX=1 (read
at import into `_SAFE_SOFTMAX`, as JAX does) swaps in K3
(`flash_fwd_online`, the online-max forward) for both, and K4 then runs
without the clamp.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from maskunet_tpu_torch.core import layers
from maskunet_tpu_torch.ops import flash_kernels

NEG_INF = flash_kernels.NEG_INF
_NOMAX_CLAMP = flash_kernels._NOMAX_CLAMP
COMPACT_MIN_TOKENS = 4096
# MASKUNET_SAFE_SOFTMAX=1: the online-max forward (K3) instead of the
# clamped no-max one (K1, K2), for serving and training alike; the results
# differ only where a base-2 score exceeds _NOMAX_CLAMP.
_SAFE_SOFTMAX = os.environ.get("MASKUNET_SAFE_SOFTMAX", "0") == "1"


def _flash_fwd(q, k, v, bias, scale, use_valid, *, need_lse: bool):
    """(o, lse or None), dispatched as JAX's `_flash_fwd` (:227-303): K1
    without lse, K2 with it, K3 for both under `_SAFE_SOFTMAX` (its lse is
    dropped when not needed)."""
    if _SAFE_SOFTMAX:
        o, lse = flash_kernels.flash_fwd_online(q, k, v, bias, scale,
                                                use_valid)
        return o, lse if need_lse else None
    if need_lse:
        return flash_kernels.flash_fwd_nomax_lse(q, k, v, bias, scale,
                                                 use_valid)
    return flash_kernels.flash_fwd_nomax(q, k, v, bias, scale,
                                         use_valid), None


class _FlashMHA(torch.autograd.Function):
    """`flash_mha` under autograd: the K2 (or, safe, K3) forward saving (q,
    k, v, bias, o, lse), the K4 backward, clamped after K2 only. `ctx.safe`
    is the switch as the forward saw it, so the backward matches the lse
    it gets whatever the switch says by then. The bias gets no gradient,
    as in JAX (:471)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, use_valid):
        ctx.safe = _SAFE_SOFTMAX
        o, lse = _flash_fwd(q, k, v, bias, scale, use_valid, need_lse=True)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale, ctx.use_valid = scale, use_valid
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_kernels.flash_bwd(q, k, v, bias, o, lse,
                                             do.contiguous(), ctx.scale,
                                             ctx.use_valid,
                                             clamp=not ctx.safe)
        return dq, dk, dv, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, scale: float,
              use_valid: bool = True) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per batch row, through the flash
    kernels (`_flash_fwd`). `use_valid=False` skips the explicit masked-key
    zeroing, which is exact only when every row has a visible key (the
    compacted path guarantees it). Differentiable in q, k and v; not in
    the bias."""
    if torch.is_grad_enabled():
        if bias.requires_grad:
            raise ValueError("flash_mha gives the bias no gradient (as JAX's "
                             "custom VJP); pass a bias that does not "
                             "require grad")
        if q.requires_grad or k.requires_grad or v.requires_grad:
            return _FlashMHA.apply(q, k, v, bias, scale, use_valid)
    return _flash_fwd(q, k, v, bias, scale, use_valid, need_lse=False)[0]


def mask_to_bias(key_mask: torch.Tensor | None, batch: int, l: int, *,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Boolean keep-mask [B, L] -> additive f32 bias [B, 1, L]."""
    if key_mask is None:
        return torch.zeros(batch, 1, l, device=device)
    bias = torch.zeros(key_mask.shape, dtype=torch.float32,
                       device=key_mask.device)
    return bias.masked_fill(~key_mask, NEG_INF)[:, None, :]


def _key_capacity(l: int, density: float = 0.5) -> int:
    """Compacted key count for a Bernoulli(density) mask over l keys: the
    mean kept count plus an 8-sigma margin, rounded up to 512."""
    margin = 8 * int(math.sqrt(l * density * (1.0 - density))) + 1
    cap = int(math.ceil(l * density)) + margin
    return min(l, -(-cap // 512) * 512)


class CompactPlan(NamedTuple):
    """Mask-derived compaction indices, computed once per cached mask."""
    idx: torch.Tensor    # [B, cap] int64: source position of each slot
    valid: torch.Tensor  # [B, cap] bool: slot < kept count
    bad: torch.Tensor    # [B, 1] bool: overflow or empty rows (poisoned)


def plan_compaction(key_mask: torch.Tensor, *,
                    density: float = 0.5) -> CompactPlan:
    """Stable partition of each row's visible keys into `_key_capacity`
    slots; rows that overflow the capacity or see no key are marked bad."""
    b, l = key_mask.shape
    cap = _key_capacity(l, density)
    ones = key_mask.long()
    pos = torch.cumsum(ones, dim=1) - 1
    slot = torch.where(key_mask, torch.clamp(pos, max=cap), cap)
    src = torch.arange(l, device=key_mask.device).expand(b, l)
    idx = torch.zeros(b, cap + 1, dtype=torch.long, device=key_mask.device)
    idx = idx.scatter(1, slot, src)[:, :cap]
    total = ones.sum(dim=1, keepdim=True)
    bad = (total > cap) | (total == 0)
    count = torch.clamp(total, max=cap)
    valid = torch.arange(cap, device=key_mask.device)[None, :] < count
    return CompactPlan(idx=idx, valid=valid, bad=bad)


def compact_keys(k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
                 *, density: float = 0.5, plan: CompactPlan | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather the visible keys and values into the capacity buffer;
    returns (k_c, v_c, valid). K of bad rows is NaN. `plan` must come from
    this same `key_mask`; None computes it here."""
    if plan is None:
        plan = plan_compaction(key_mask, density=density)
    gather = plan.idx[..., None].expand(-1, -1, k.shape[-1])
    k_c = torch.gather(k, 1, gather)
    v_c = torch.gather(v, 1, gather)
    k_c = k_c.masked_fill(plan.bad[..., None], float("nan"))
    return k_c, v_c, plan.valid


def masked_attention_flash(params: dict, tokens: torch.Tensor,
                           key_mask: torch.Tensor | None, *,
                           mask_density: float | None = 0.5,
                           plan: CompactPlan | None = None) -> torch.Tensor:
    """Drop-in for `attention.masked_attention_dense` on the kernel: one
    fused [3C, C] QKV projection, q pre-scaled by 1/sqrt(C) (so the kernel
    runs at scale 1), K/V compaction on layers of >= COMPACT_MIN_TOKENS
    tokens (`mask_density` None disables it), then residual + LayerNorm."""
    b, l, c = tokens.shape
    wqkv = torch.cat([params["query.weight"], params["key.weight"],
                      params["value.weight"]])
    bqkv = torch.cat([params["query.bias"], params["key.bias"],
                      params["value.bias"]])
    qkv = layers.linear(wqkv, bqkv, tokens)
    q = qkv[..., :c] * layers.weak_scalar(1.0 / (c ** 0.5), tokens.dtype)
    k = qkv[..., c:2 * c]
    v = qkv[..., 2 * c:]
    use_valid = True
    if (key_mask is not None and mask_density is not None
            and l >= COMPACT_MIN_TOKENS):
        k, v, key_mask = compact_keys(k, v, key_mask, density=mask_density,
                                      plan=plan)
        use_valid = False
    else:
        k, v = k.contiguous(), v.contiguous()
    bias = mask_to_bias(key_mask, b, k.shape[1], device=tokens.device)
    out = flash_mha(q, k, v, bias, 1.0, use_valid) + tokens
    return layers.layernorm(params["norm.weight"], params["norm.bias"], out)
