"""The flash-attention kernels: CUDA sources, their build, their wrappers
and their plain PyTorch versions.

- `flash_fwd_nomax` (K1): the Pallas TPU kernel `_fwd_kernel_nomax` with
  `with_lse=False` (maskunet_tpu/ops/flash_attention.py:164-218), the
  primal of `flash_mha`.
- `flash_fwd_nomax_lse` (K2): the same kernel with `with_lse=True`, the
  training forward, which also returns lse2 = log2(max(l, 1e-30)).
- `flash_fwd_online` (K3): the online-max forward `_fwd_kernel`
  (:111-161), which returns lse2 = m + log2(max(l, 1e-30)); the safe
  softmax that MASKUNET_SAFE_SOFTMAX=1 selects.
- `flash_bwd` (K4): the merged backward `_bwd_kernel` (:323-389), with the
  clamp at 2^60 (after K2) or without it (`clamp=False`, after K3).

Their CUDA sources, `csrc/flash_fwd_nomax.cu` (K1 and K2, and the A/B
tools' K6 with its repack kernel), `csrc/flash_fwd_online.cu` (K3, and
the tools' K5 and K7) and `csrc/flash_bwd.cu` (K4), are compiled for
sm_90a with nvcc at the first launch of any of them, all at once, into
`maskunet_tpu_torch/_build/` (shared libraries with plain C entry points,
loaded with ctypes), and launch on the current CUDA stream.
The wrappers of K5-K7 sit in `maskunet_tpu_torch/tools/`.

A tensor on the CPU goes to the wrapper's plain version (`*_reference`,
the same math in plain PyTorch); a CUDA tensor always launches the kernel
(or raises). Each wrapper counts its launches in `<wrapper>.launches`.

K1 and K3, the serving forwards, are also the PyTorch operators
`maskunet::flash_fwd_nomax` and `maskunet::flash_fwd_online` (registered
at import, with a shape-only fake for tracing), so that `torch.export`
keeps them in an exported program (`maskunet_tpu_torch.export`): the
ctypes launch on `data_ptr()` cannot be traced. The operator's body is the
wrapper's (plain version on the CPU, launch on the card); it allocates its
outputs and writes no input. Eager calls skip the dispatcher and run the
body directly.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from maskunet_tpu_torch.core.layers import weak_scalar

NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_NOMAX_CLAMP = 60.0
KERNEL_CHANNELS = (64, 128, 256)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("flash_fwd_nomax", "flash_fwd_online", "flash_bwd")}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def flash_fwd_nomax_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              scale: float, use_valid: bool = True,
                              with_lse: bool = False):
    """Plain PyTorch version of K1 (and, `with_lse`, K2): q [B,Lq,C], k/v
    [B,Lk,C] (bf16 or f32), bias [B,1,Lk] f32 in {0, NEG_INF}; returns o
    [B,Lq,C] in q's dtype, and with `with_lse` (o, lse [B,1,Lq] f32).
    Follows the TPU kernel's arithmetic: q*scale*log2e rounded to q's dtype
    (the constant too, as JAX's weak typing does), f32 scores, a
    NaN-propagating clamp at 2^60, p rounded to v's dtype for P.V while the
    row sum l uses the f32 p; lse = log2(max(l, 1e-30)), NaN kept. Loops
    over the batch to bound the [Lq, Lk] temporaries."""
    qs = q * weak_scalar(scale * _LOG2E, q.dtype)
    valid = bias > NEG_INF * 0.5
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], 1, q.shape[1], device=q.device)
    for i in range(q.shape[0]):
        s = torch.matmul(qs[i].float(), k[i].float().transpose(0, 1))
        p = torch.exp2(torch.clamp(s + bias[i], max=_NOMAX_CLAMP))
        if use_valid:
            p = p * valid[i]
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), v[i].float())
        out[i] = (acc / l).to(q.dtype)
        lse[i, 0] = torch.log2(l[:, 0])
    return (out, lse) if with_lse else out


def flash_fwd_online_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               scale: float, use_valid: bool = True):
    """Plain PyTorch version of K3: (o [B,Lq,C] in q's dtype, lse [B,1,Lq]
    f32). Follows the TPU kernel's arithmetic with the row max taken over
    all keys at once: q*scale*log2e rounded to q's dtype, s = q k^T + bias
    in f32, m = max(NEG_INF, max_j s) (amax and clamp keep NaN), p =
    exp2(s - m) [* valid], p rounded to v's dtype for P.V while l sums the
    f32 p; lse = m + log2(max(l, 1e-30)). A fully masked row has m =
    NEG_INF and p = 1 on every key: o = 0 with use_valid, the mean of V
    without."""
    qs = q * weak_scalar(scale * _LOG2E, q.dtype)
    valid = bias > NEG_INF * 0.5
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], 1, q.shape[1], device=q.device)
    for i in range(q.shape[0]):
        s = torch.matmul(qs[i].float(), k[i].float().transpose(0, 1))
        s = s + bias[i]
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
        p = torch.exp2(s - m)
        if use_valid:
            p = p * valid[i]
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), v[i].float())
        out[i] = (acc / l).to(q.dtype)
        lse[i, 0] = (m + torch.log2(l))[:, 0]
    return out, lse


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = sum_c dO * O in f32, [B, 1, Lq] (JAX computes it in XLA
    before the backward kernel, flash_attention.py:397-398)."""
    return (do.float() * o.float()).sum(dim=-1)[:, None, :]


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, scale: float,
                        use_valid: bool = True, clamp: bool = True):
    """Plain PyTorch version of K4: the gradients (dq, dk, dv) of the
    attention `flash_fwd_nomax_lse` (`clamp`) or `flash_fwd_online` (not
    `clamp`) computed, in q's, k's and v's dtypes. Follows the TPU kernel
    step by step: s = (q*scale*log2e rounded to q's dtype) k^T + bias in
    f32, with `clamp` a NaN-propagating min(s, 60), p = exp2(s - lse) [*
    valid]; dv = p(in dO's dtype)^T dO; ds = p (dO v^T - delta);
    ds rounded to q's dtype; dk = scale ds^T q and dq = scale ds k with the
    raw q and k, in f32. Loops over the batch to bound the [Lq, Lk]
    temporaries."""
    qs = q * weak_scalar(scale * _LOG2E, q.dtype)
    valid = bias > NEG_INF * 0.5
    delta = _delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for i in range(q.shape[0]):
        s = torch.matmul(qs[i].float(), k[i].float().transpose(0, 1))
        s = s + bias[i]
        if clamp:
            s = torch.clamp(s, max=_NOMAX_CLAMP)
        p = torch.exp2(s - lse[i].transpose(0, 1))
        if use_valid:
            p = p * valid[i]
        dof = do[i].float()
        dv[i] = torch.matmul(p.to(do.dtype).float().transpose(0, 1),
                             dof).to(v.dtype)
        dp = torch.matmul(dof, v[i].float().transpose(0, 1))
        ds = (p * (dp - delta[i].transpose(0, 1))).to(q.dtype).float()
        dk[i] = (torch.matmul(ds.transpose(0, 1), q[i].float())
                 * scale).to(k.dtype)
        dq[i] = (torch.matmul(ds, k[i].float()) * scale).to(q.dtype)
    return dq, dk, dv


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the flash kernels are built from "
                       f"{_PKG / 'csrc'} on a machine with the CUDA toolkit")


def build() -> dict[str, dict]:
    """Compile every kernel library whose source has not been built yet,
    one nvcc process for each, all started together. Returns {name:
    {"path", "seconds", "cached", "log"}}; `log` holds ptxas's register,
    shared-memory and spill report of a fresh build."""
    out: dict[str, dict] = {}
    running = {}
    for name, source in SOURCES.items():
        digest = hashlib.sha256(source.read_bytes() + " ".join(
            NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{name}_{digest}.so"
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "cached": True,
                         "log": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, time.monotonic(), source, lib, tmp)
    failed = []
    for name, (proc, t0, source, lib, tmp) in running.items():
        text = proc.communicate()[0]
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {source}:\n"
                          f"{text}")
            continue
        lib.with_suffix(".log").write_text(text)
        os.replace(tmp, lib)
        out[name] = {"path": str(lib), "seconds": seconds, "cached": False,
                     "log": text}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> (library, argument types); every entry returns a CUDA error
_ENTRIES = {
    "flash_fwd_nomax": ("flash_fwd_nomax",
                        [_ptr] * 5 + [_int] * 6 + [_float, _ptr]),
    "flash_fwd_nomax_lse": ("flash_fwd_nomax",
                            [_ptr] * 6 + [_int] * 6 + [_float, _ptr]),
    "flash_fwd_online": ("flash_fwd_online",
                         [_ptr] * 6 + [_int] * 6 + [_float, _ptr]),
    "flash_fwd_online_exp": ("flash_fwd_online", [_ptr] * 6 + [_int] * 4
                             + [_ptr]),
    "flash_fwd_online_bf16": ("flash_fwd_online", [_ptr] * 6 + [_int] * 4
                              + [_ptr]),
    "flash_repack65": ("flash_fwd_nomax", [_ptr] * 3 + [_int] * 2 + [_ptr]),
    "flash_fwd_nomax65": ("flash_fwd_nomax", [_ptr] * 6 + [_int] * 4
                          + [_ptr]),
    "flash_bwd": ("flash_bwd", [_ptr] * 10 + [_int] * 7 + [_float] * 2
                  + [_ptr]),
    "flash_bwd_body": ("flash_bwd", [_int]),
    "flash_fwd_nomax_body": ("flash_fwd_nomax", [_int]),
    "flash_fwd_online_body": ("flash_fwd_online", [_int]),
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point `name`, from its library (built on first use)."""
    lib_name, argtypes = _ENTRIES[name]
    fn = getattr(ctypes.CDLL(build()[lib_name]["path"]), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# Channels whose bf16 K4 runs the wgmma body (`wgmma_body` in
# csrc/flash_bwd.cu; `flash_bwd_body` reads the library's own answer).
BWD_WGMMA_CHANNELS = (64, 128)
# Channels whose bf16 K1 and K2 run the wgmma body (`wgmma_body` in
# csrc/flash_fwd_nomax.cu; `flash_fwd_nomax_body` reads the library's).
FWD_WGMMA_CHANNELS = (64, 128, 256)
# Channels whose bf16 K3 runs the wgmma body (`wgmma_body` in
# csrc/flash_fwd_online.cu, which K7 follows at C = 64;
# `flash_fwd_online_body` reads the library's).
ONLINE_WGMMA_CHANNELS = (64, 128, 256)
_BODIES = {2: "wgmma", 1: "mma_sync"}


def flash_bwd_body(c: int, dtype: torch.dtype) -> str:
    """The body K4 runs at `c` channels in `dtype` on the card: "wgmma",
    "mma_sync" (bf16) or "fma" (f32); asks the built library."""
    if dtype == torch.float32:
        return "fma"
    return _BODIES[_entry("flash_bwd_body")(c)]


def flash_fwd_nomax_body(c: int, dtype: torch.dtype) -> str:
    """The body K1 and K2 run at `c` channels in `dtype` on the card, as
    `flash_bwd_body` says K4's."""
    if dtype == torch.float32:
        return "fma"
    return _BODIES[_entry("flash_fwd_nomax_body")(c)]


def flash_fwd_online_body(c: int, dtype: torch.dtype) -> str:
    """The body K3 runs at `c` channels in `dtype` on the card (K7 runs
    K3's at C = 64), as `flash_bwd_body` says K4's."""
    if dtype == torch.float32:
        return "fma"
    return _BODIES[_entry("flash_fwd_online_body")(c)]


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = _entry(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# Batch rows a launch takes: every kernel puts the batch on the grid's y
# dimension, which stops at 65,535. 65,528 is the largest multiple of 8
# below it, so each chunk of an f32 [B, 1, L] row (bias, lse, delta, K6's
# qa and kb) still starts on a 16-byte boundary.
MAX_BATCH_ROWS = 65528


def _launch_batched(name: str, tensors: tuple, *rest,
                    rows: int = MAX_BATCH_ROWS) -> int:
    """Launches `name` once for each chunk of at most `rows` batch rows
    (rows are independent in every kernel): the arguments are each tensor
    of `tensors` ([B, ...], contiguous) at the chunk's first row, the
    chunk's row count, then `rest`. Returns the number of launches."""
    b = tensors[0].shape[0]
    # pointers by arithmetic, not slices: the wrappers are on the host's
    # critical path, and most calls are one chunk
    ptrs = [(t.data_ptr(), t.stride(0) * t.element_size()) for t in tensors]
    for i in range(0, b, rows):
        _launch(name, tensors[0].device, *(p + i * row for p, row in ptrs),
                min(rows, b - i), *rest)
    return -(-b // rows)


def _on_card(q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return True


def _check_layout(name: str, t: torch.Tensor, device: torch.device,
                  align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        # the kernels read rows with 16-byte vector loads, cp.async and
        # TMA (K6's repack reads 130-byte q65 / k65 rows by 2-byte loads)
        raise ValueError(f"{name} must start on a {align}-byte boundary")


def _check(q, k, v, bias) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, L, C]")
    b, _, c = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, c) or v.shape != (b, lk, c):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(bias.shape) != (b, 1, lk) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be f32 [{b}, 1, {lk}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"channels {c} not in {KERNEL_CHANNELS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        _check_layout(name, t, q.device)


def _flash_fwd_nomax_impl(q, k, v, bias, scale, use_valid):
    """The body of K1's operator: the plain version for a CPU tensor, the
    launch for a CUDA tensor."""
    if not _on_card(q):
        return flash_fwd_nomax_reference(q, k, v, bias, scale, use_valid)
    _check(q, k, v, bias)
    b, lq, c = q.shape
    o = torch.empty_like(q)
    launched = _launch_batched(
        "flash_fwd_nomax", (q, k, v, bias, o), lq, k.shape[1], c,
        int(q.dtype == torch.bfloat16), int(use_valid),
        weak_scalar(scale * _LOG2E, q.dtype))
    # counted after the launch returns: a count never spans the launch, so
    # launches from two threads (the pipeline's stages) lose none
    flash_fwd_nomax.launches += launched
    return o


@torch.library.custom_op("maskunet::flash_fwd_nomax", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_fwd_nomax_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, scale: float,
                        use_valid: bool) -> torch.Tensor:
    return _flash_fwd_nomax_impl(q, k, v, bias, scale, use_valid)


@_flash_fwd_nomax_op.register_fake
def _(q, k, v, bias, scale, use_valid):
    return torch.empty_like(q)


def flash_fwd_nomax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float,
                    use_valid: bool = True) -> torch.Tensor:
    """K1: masked attention forward without online max (see the module
    docstring). CPU tensors run the plain version; CUDA tensors launch
    the kernel. Under `torch.export` (or `torch.compile`) the call is the
    operator `maskunet::flash_fwd_nomax`, which the traced graph keeps;
    eager calls its body directly, without the dispatcher's host time."""
    if torch.compiler.is_compiling():
        return _flash_fwd_nomax_op(q, k, v, bias, float(scale),
                                   bool(use_valid))
    return _flash_fwd_nomax_impl(q, k, v, bias, scale, use_valid)


flash_fwd_nomax.launches = 0


def flash_fwd_nomax_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, scale: float,
                        use_valid: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: K1 that also returns lse [B, 1, Lq] f32, the base-2 log of each
    query row's sum for the backward. CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    if not _on_card(q):
        return flash_fwd_nomax_reference(q, k, v, bias, scale, use_valid,
                                         with_lse=True)
    _check(q, k, v, bias)
    b, lq, c = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, 1, lq, device=q.device)
    launched = _launch_batched(
        "flash_fwd_nomax_lse", (q, k, v, bias, o, lse), lq, k.shape[1], c,
        int(q.dtype == torch.bfloat16), int(use_valid),
        weak_scalar(scale * _LOG2E, q.dtype))
    flash_fwd_nomax_lse.launches += launched
    return o, lse


flash_fwd_nomax_lse.launches = 0


def _flash_fwd_online_impl(q, k, v, bias, scale, use_valid):
    """The body of K3's operator: the plain version for a CPU tensor, the
    launch for a CUDA tensor."""
    if not _on_card(q):
        return flash_fwd_online_reference(q, k, v, bias, scale, use_valid)
    _check(q, k, v, bias)
    b, lq, c = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, 1, lq, device=q.device)
    launched = _launch_batched(
        "flash_fwd_online", (q, k, v, bias, o, lse), lq, k.shape[1], c,
        int(q.dtype == torch.bfloat16), int(use_valid),
        weak_scalar(scale * _LOG2E, q.dtype))
    flash_fwd_online.launches += launched
    return o, lse


@torch.library.custom_op("maskunet::flash_fwd_online", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_fwd_online_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, scale: float, use_valid: bool
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    return _flash_fwd_online_impl(q, k, v, bias, scale, use_valid)


@_flash_fwd_online_op.register_fake
def _(q, k, v, bias, scale, use_valid):
    return (torch.empty_like(q),
            q.new_empty(q.shape[0], 1, q.shape[1], dtype=torch.float32))


def flash_fwd_online(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float, use_valid: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: masked attention forward with an online max; returns (o, lse
    [B, 1, Lq] f32 = m + log2(max(l, 1e-30))). CPU tensors run the plain
    version; CUDA tensors launch the kernel. Traced, the call is the
    operator `maskunet::flash_fwd_online`, as for `flash_fwd_nomax`."""
    if torch.compiler.is_compiling():
        return _flash_fwd_online_op(q, k, v, bias, float(scale),
                                    bool(use_valid))
    return _flash_fwd_online_impl(q, k, v, bias, scale, use_valid)


flash_fwd_online.launches = 0


def _bwd_chunk_rows(lq: int, c: int, dtype: torch.dtype) -> int:
    """Batch rows a K4 launch takes: MAX_BATCH_ROWS, and for the wgmma body
    also B * Lq < 2^31 a launch, which keeps every query row's flat index
    an int32, in a multiple of 8. Raises ValueError where not even 8 rows
    fit (Lq >= 2^28)."""
    rows = MAX_BATCH_ROWS
    if dtype == torch.bfloat16 and c in BWD_WGMMA_CHANNELS:
        rows = min(rows, (2 ** 31 - 1) // max(lq, 1) // 8 * 8)
        if rows == 0:
            raise ValueError(f"flash_bwd's wgmma body takes 8 * Lq < 2^31, "
                             f"got Lq = {lq}")
    return rows


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor, scale: float, use_valid: bool = True,
              clamp: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: the merged backward of `flash_fwd_nomax_lse` (`clamp`: scores
    clamped at 60 as that forward did) or of `flash_fwd_online` (`clamp`
    False: its lse holds the row max and may exceed 60); o, lse are the
    forward's outputs, do the gradient of o. Returns (dq, dk, dv) in q's,
    k's and v's dtypes. delta = sum(do * o) is computed here with torch
    ops, as JAX does in XLA. dq accumulates in f32 by bulk reductions
    (bf16 at C = 64 and 128) or atomics in the kernel, so its last bits vary from
    run to run. CPU tensors run the plain version; CUDA tensors launch the
    kernel, or raise ValueError for what it cannot take."""
    if not _on_card(q):
        return flash_bwd_reference(q, k, v, bias, o, lse, do, scale,
                                   use_valid, clamp)
    _check(q, k, v, bias)
    b, lq, c = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        _check_layout(name, t, q.device)
    if tuple(lse.shape) != (b, 1, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [{b}, 1, {lq}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    _check_layout("lse", lse, q.device)
    rows = _bwd_chunk_rows(lq, c, q.dtype)
    delta = _delta(o, do)
    dq = torch.zeros(b, lq, c, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launched = _launch_batched(
        "flash_bwd", (q, k, v, bias, do, lse, delta, dq, dk, dv), lq,
        k.shape[1], c, int(q.dtype == torch.bfloat16), int(use_valid),
        int(clamp), weak_scalar(scale * _LOG2E, q.dtype), float(scale),
        rows=rows)
    flash_bwd.launches += launched
    return dq.to(q.dtype), dk, dv


flash_bwd.launches = 0
