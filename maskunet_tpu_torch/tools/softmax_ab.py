"""Same-process A/B of forward softmax variants at the attn6 shape (batch 8,
16,384 queries x 9,216 compacted key slots, C 64, bf16), on the card.
Counterpart of tools/softmax_ab.py, with its two kernels:

- K5 `old_flash_fwd`: the JAX tool's `_old_fwd_kernel` (tools/softmax_ab.py
  :29-60), natural exp with an online max, no q scale, no use_valid; CUDA
  in csrc/flash_fwd_online.cu (entry `flash_fwd_online_exp`, K3's wgmma
  body).
- K6 `nomax65_fwd`: its `_nomax65_kernel` (:157-181), no max, the bias as
  a 65th channel of q and k, clamped at 2^60 or not; CUDA in
  csrc/flash_fwd_nomax.cu: `repack65` splits q65 and k65 into 64
  channels (q64, k64) and the 65th as f32 (qa, kb), then a mode of K1's
  wgmma body scores q64 k64^T + qa kb^T (entry `flash_fwd_nomax65`).

Both take bf16 at C = 64 only (V's C for K6), the one instantiation the
tool launches; a wrapper raises on anything else. CPU tensors run their
plain versions, CUDA tensors launch the kernels, counted in
`<wrapper>.launches` (K6's repack in `repack65.launches`).

    python -m maskunet_tpu_torch.tools.softmax_ab [batch]      # A/B/C
    python -m maskunet_tpu_torch.tools.softmax_ab 2 [batch]    # C/D/E

  A: K5, natural exp and online max.
  B: `flash_attention._flash_fwd(need_lse=True)`, the training forward:
     K2 (exp2, no max, clamp at 2^60, with lse), or K3 (exp2, online max)
     under MASKUNET_SAFE_SOFTMAX=1. (The JAX tool's docstring calls B
     "exp2, online max"; its code runs the no-max kernel unless the switch
     is set, and so does this one.)
  C: `_flash_fwd(need_lse=False)`, the serving forward: K1, or K3 under
     the switch.
  D: K6 with the clamp; E: K6 without it.

Inputs as the JAX tool's (drawn with torch from seed 0): q ~ N(0, 1) * 0.35,
k, v ~ N(0, 1), all keys visible (bias 0). Every variant is timed with CUDA
events after a warm-up: the minimum over 3 windows of 30 calls, the
variants taking turns.
"""

from __future__ import annotations

import math
import sys

import torch

from maskunet_tpu_torch.core.layers import weak_scalar
from maskunet_tpu_torch.ops import flash_attention as fa
from maskunet_tpu_torch.ops import flash_kernels as fk

LQ, C = 16384, 64


def check_bf16_c64(name: str, q: torch.Tensor, v: torch.Tensor) -> None:
    """The tools' kernels exist for bf16 at C = 64 only."""
    if q.dtype != torch.bfloat16 or v.dtype != torch.bfloat16 \
            or v.shape[-1] != C:
        raise ValueError(f"{name} takes bf16 at C = {C} only, got "
                         f"{q.dtype} / {v.dtype} with C = {v.shape[-1]}")


def old_flash_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor):
    """Plain version of K5: (o in q's dtype, lse [B, 1, Lq] f32). s = q k^T
    + bias in f32 (q as given), m = max(NEG_INF, max_j s) (NaN kept), p =
    exp(s - m), p rounded to v's dtype for P.V while l sums the f32 p, o =
    P.V / max(l, 1e-30), lse = m + ln(max(l, 1e-30)). A fully masked row
    gives the mean of V."""
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], 1, q.shape[1], device=q.device)
    for i in range(q.shape[0]):
        s = torch.matmul(q[i].float(), k[i].float().transpose(0, 1)) + bias[i]
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=fk.NEG_INF)
        p = torch.exp(s - m)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), v[i].float())
        out[i] = (acc / l).to(q.dtype)
        lse[i, 0] = (m + torch.log(l))[:, 0]
    return out, lse


def old_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 on q, k, v [B, L, 64] bf16 and bias [B, 1, Lk] f32: (o, lse)."""
    check_bf16_c64("old_flash_fwd", q, v)
    if not fk._on_card(q):
        return old_flash_fwd_reference(q, k, v, bias)
    fk._check(q, k, v, bias)
    b, lq, c = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, 1, lq, device=q.device)
    old_flash_fwd.launches += fk._launch_batched(
        "flash_fwd_online_exp", (q, k, v, bias, o, lse), lq, k.shape[1], c)
    return o, lse


old_flash_fwd.launches = 0


def _nomax65_from_scores(scores, lq: int, v: torch.Tensor, clamp: bool
                         ) -> torch.Tensor:
    """K6's softmax and P.V, batch row by batch row: `scores(i)` gives row
    i's f32 s [Lq, Lk]; p = exp2(min(s, 60)) (`clamp`, NaN kept) or
    exp2(s), p rounded to v's dtype for P.V while l sums the f32 p; o =
    P.V / max(l, 1e-30) in v's dtype, [B, Lq, 64]."""
    out = torch.empty(v.shape[0], lq, v.shape[-1], dtype=v.dtype,
                      device=v.device)
    for i in range(v.shape[0]):
        s = scores(i)
        if clamp:
            s = torch.clamp(s, max=fk._NOMAX_CLAMP)
        p = torch.exp2(s)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), v[i].float())
        out[i] = (acc / l).to(v.dtype)
    return out


def nomax65_fwd_reference(q65: torch.Tensor, k65: torch.Tensor,
                          v: torch.Tensor, clamp: bool = True
                          ) -> torch.Tensor:
    """Plain version of K6: s = q65 k65^T in f32, then as
    `_nomax65_from_scores`."""
    return _nomax65_from_scores(
        lambda i: torch.matmul(q65[i].float(), k65[i].float().transpose(0, 1)),
        q65.shape[1], v, clamp)


def repack65_reference(x65: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6's repack: (x64 [B, L, 64], the first 64
    channels of x65 [B, L, 65], xa [B, L] f32, its 65th channel)."""
    return x65[..., :C].contiguous(), x65[..., C].float()


def repack65(x65: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's repack kernel on x65 [B, L, 65] bf16 (2-byte aligned rows of
    130 bytes, which no TMA map or cp.async reads): (x64 [B, L, 64] bf16,
    xa [B, L] f32), as `repack65_reference`."""
    if x65.dim() != 3 or x65.shape[-1] != C + 1 \
            or x65.dtype != torch.bfloat16:
        raise ValueError(f"repack65 takes bf16 [B, L, 65], got {x65.dtype} "
                         f"{tuple(x65.shape)}")
    if not fk._on_card(x65):
        return repack65_reference(x65)
    fk._check_layout("x65", x65, x65.device, align=2)
    b, l, _ = x65.shape
    x64 = torch.empty(b, l, C, dtype=x65.dtype, device=x65.device)
    xa = torch.empty(b, l, device=x65.device)
    if x65.numel():
        fk._launch("flash_repack65", x65.device, x65.data_ptr(),
                   x64.data_ptr(), xa.data_ptr(), b, l)
        repack65.launches += 1
    return x64, xa


repack65.launches = 0


def nomax65_split_reference(q64: torch.Tensor, qa: torch.Tensor,
                            k64: torch.Tensor, kb: torch.Tensor,
                            v: torch.Tensor, clamp: bool = True
                            ) -> torch.Tensor:
    """Plain version of K6's kernel on the repacked inputs: s = q64 k64^T
    + qa kb^T in f32 (qa kb exact: a product of two bf16 values), then as
    `_nomax65_from_scores`."""
    return _nomax65_from_scores(
        lambda i: torch.matmul(q64[i].float(), k64[i].float().transpose(0, 1))
        + qa[i][:, None] * kb[i][None, :], q64.shape[1], v, clamp)


def nomax65_fwd(q65: torch.Tensor, k65: torch.Tensor, v: torch.Tensor,
                clamp: bool = True) -> torch.Tensor:
    """K6 on q65 [B, Lq, 65], k65 [B, Lk, 65] and v [B, Lk, 64], all bf16:
    o [B, Lq, 64] bf16. `clamp` is variant D, not `clamp` variant E. On the
    card `repack65` splits q65 and k65 into a workspace, then the kernel
    runs on it."""
    check_bf16_c64("nomax65_fwd", q65, v)
    b, lq, c65 = q65.shape
    lk = k65.shape[1]
    if (c65 != C + 1 or k65.shape != (b, lk, C + 1)
            or v.shape != (b, lk, C) or k65.dtype != torch.bfloat16):
        raise ValueError(f"nomax65_fwd needs q65 [B, Lq, 65], k65 [B, Lk, "
                         f"65] bf16 and v [B, Lk, 64]; got {tuple(q65.shape)}"
                         f", {tuple(k65.shape)} {k65.dtype}, "
                         f"{tuple(v.shape)}")
    if not fk._on_card(q65):
        return nomax65_fwd_reference(q65, k65, v, clamp)
    for name, t in (("q65", q65), ("k65", k65)):
        fk._check_layout(name, t, q65.device, align=2)
    fk._check_layout("v", v, q65.device)
    q64, qa = repack65(q65)
    k64, kb = repack65(k65)
    o = torch.empty(b, lq, C, dtype=v.dtype, device=v.device)
    nomax65_fwd.launches += fk._launch_batched(
        "flash_fwd_nomax65", (q64, qa, k64, kb, v, o), lq, lk, int(clamp))
    return o


nomax65_fwd.launches = 0


def attn6_inputs(batch: int, device="cuda", seed: int = 0):
    """q, k, v and the bias of the JAX tool's A/B: bf16 q ~ N(0, 1) * 0.35
    and k, v ~ N(0, 1) over `_key_capacity(16384)` = 9,216 key slots, all
    visible."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cap = fa._key_capacity(LQ)
    q = torch.randn(batch, LQ, C, generator=gen, device=device).bfloat16() \
        * weak_scalar(0.35, torch.bfloat16)
    k, v = (torch.randn(batch, cap, C, generator=gen,
                        device=device).bfloat16() for _ in range(2))
    return q, k, v, torch.zeros(batch, 1, cap, device=device)


def bias_as_channel(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor):
    """(q65, k65) of variants D and E: [q * log2e, 1] and [k, bias], bf16."""
    ones = torch.ones(*q.shape[:2], 1, dtype=q.dtype, device=q.device)
    q65 = torch.cat([q * weak_scalar(fk._LOG2E, q.dtype), ones], dim=-1)
    k65 = torch.cat([k, bias.transpose(1, 2).to(k.dtype)], dim=-1)
    return q65, k65


def min_window_ms(fns: dict, iters: int = 30, windows: int = 3) -> dict:
    """{name: ms per call}: CUDA events around `iters` calls, the minimum
    over `windows` windows in which the variants take turns; one warm-up
    call of each first."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(windows):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            best[name] = min(best[name], start.elapsed_time(end) / iters)
    return best


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def need_card(tool: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; this tool runs on the card")


def main(argv: list[str] | None = None) -> dict:
    """A (K5) / B (training forward) / C (serving forward); returns the
    printed numbers."""
    argv = sys.argv[1:] if argv is None else argv
    need_card("softmax_ab")
    batch = int(argv[0]) if argv else 8
    q, k, v, bias = attn6_inputs(batch)
    cap = k.shape[1]
    print(f"device={torch.cuda.get_device_name(0)} batch={batch} Lq={LQ} "
          f"cap={cap} C={C} bf16 safe_softmax={fa._SAFE_SOFTMAX}", flush=True)
    fns = {"old": lambda: old_flash_fwd(q, k, v, bias)[0],
           "exp2": lambda: fa._flash_fwd(q, k, v, bias, 1.0, False,
                                         need_lse=True)[0],
           "nomax": lambda: fa._flash_fwd(q, k, v, bias, 1.0, False,
                                          need_lse=False)[0]}
    outs = {name: fn() for name, fn in fns.items()}
    d1 = _max_abs(outs["old"], outs["exp2"])
    d2 = _max_abs(outs["old"], outs["nomax"])
    print(f"max|old-exp2|={d1:.2e}  max|old-nomax|={d2:.2e}", flush=True)
    if not (math.isfinite(d1) and math.isfinite(d2)):
        raise SystemExit("softmax_ab: non-finite difference")
    best = min_window_ms(fns)
    flops = 4 * batch * LQ * cap * C
    for name, t in best.items():
        print(f"{name:6s} {t:7.3f} ms  {flops / t / 1e9:6.1f} TF/s  "
              f"({best['old'] / t:.3f}x vs old)", flush=True)
    return {"batch": batch, "max_abs_old_exp2": d1, "max_abs_old_nomax": d2,
            "ms": best}


def main2(argv: list[str] | None = None) -> dict:
    """C (serving forward) / D (K6 clamped) / E (K6 unclamped); returns the
    printed numbers."""
    argv = sys.argv[1:] if argv is None else argv
    need_card("softmax_ab")
    batch = int(argv[1]) if len(argv) > 1 else 8
    q, k, v, bias = attn6_inputs(batch)
    q65, k65 = bias_as_channel(q, k, bias)
    print(f"device={torch.cuda.get_device_name(0)} D/E variants "
          f"batch={batch}", flush=True)
    fns = {"nomaxC": lambda: fa._flash_fwd(q, k, v, bias, 1.0, False,
                                           need_lse=False)[0],
           "bias65D": lambda: nomax65_fwd(q65, k65, v, clamp=True),
           "noclampE": lambda: nomax65_fwd(q65, k65, v, clamp=False)}
    d = _max_abs(fns["nomaxC"](), fns["bias65D"]())
    print(f"max|C-D|={d:.2e}", flush=True)
    best = min_window_ms(fns)
    for name, t in best.items():
        print(f"{name:9s} {t:7.3f} ms ({best['nomaxC'] / t:.3f}x vs C)",
              flush=True)
    return {"batch": batch, "max_abs_c_d": d, "ms": best}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "2":
        main2()
    else:
        main()
