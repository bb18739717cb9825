"""A/B of variants of the K4 source (csrc/flash_bwd.cu) on the card.

Each variant is the committed source with one text substitution, built
with the library's own nvcc flags, held against the plain version and
timed at attn6 of the ADE training step (batch 8, Lq 16,384, 9,216
compacted key slots, C 64, bf16) with CUDA events, in alternating order
over the rounds. A time includes the zeroing of dQ, as the wrapper's call
does.

    python -m maskunet_tpu_torch.tools.bwd_ab [--rounds 2]

Variants (C = 64 runs the wgmma body unless named otherwise):
  source     the committed kernel (wgmma, three warpgroups of 64 keys a
             block, a three-stage TMA ring, dQ by bulk tensor reduction)
  mma_sync   the mma.sync body the source keeps for C = 256, at C = 64
             (and 128) too: PR 3's kernel, in the same run
  atomics    dQ by float2 f32 atomicAdd instead of the bulk reduction
  stages2    a two-stage q / dO ring
  wg1        one warpgroup (64 keys) a block, two blocks an SM
  wg2        two warpgroups (128 keys) a block

It prints one JSON line per variant built (ptxas's registers and spills
of the C = 64 bf16 instantiations) and per variant timed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from maskunet_tpu_torch.ops import flash_attention as fa
from maskunet_tpu_torch.ops import flash_kernels as fk

_WGMMA_C = ("constexpr bool wgmma_body(int c) "
            "{ return c == 64 || c == 128; }")
_NO_WGMMA = "constexpr bool wgmma_body(int c) { return false; }"
_ADD = """\
  if (lane == 0) bulk_wait_read();  // this warp's last add read its rows
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unsigned char* half = dqw + (j >> 2) * kTile;
    const int c16 = 2 * (j & 3) + (tq4 >> 1);  // 16-byte chunk
    const int off = ((c16 ^ sw) << 4) + 8 * (tq4 & 1);
    *reinterpret_cast<float2*>(half + r0 * 128 + off) =
        make_float2(scale * dqa[4 * j], scale * dqa[4 * j + 1]);
    *reinterpret_cast<float2*>(half + (r0 + 8) * 128 + off) =
        make_float2(scale * dqa[4 * j + 2], scale * dqa[4 * j + 3]);
  }
  fence_async_smem();
  __syncwarp();
  if (lane == 0) {
    const int w16 = r0 - (r0 & 15);  // this warp's first row
    tma_reduce_add_3d(tdq, dqw + w16 * 128, c0, q0 + w16, b);
    tma_reduce_add_3d(tdq, dqw + kTile + w16 * 128, c0 + 32, q0 + w16, b);
    bulk_commit();
  }
"""
_ADD_ATOMICS = """\
  float* row = dq + (size_t(b) * lq + q0 + r0) * ldc + c0 + 2 * tq4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (q0 + r0 < lq)
      atomicAdd(reinterpret_cast<float2*>(row + 8 * j),
                make_float2(scale * dqa[4 * j], scale * dqa[4 * j + 1]));
    if (q0 + r0 + 8 < lq)
      atomicAdd(reinterpret_cast<float2*>(row + 8 * ldc + 8 * j),
                make_float2(scale * dqa[4 * j + 2], scale * dqa[4 * j + 3]));
  }
"""
_STAGES = "constexpr int kStages = 3;"
_STAGES2 = "constexpr int kStages = 2;"
_WGS = "constexpr int kWarpgroups = 3;"


def _sub(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"the K4 source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def variants(src: str) -> dict[str, str]:
    """{name: CUDA source} of the variants of the module docstring."""
    return {"source": _sub(src),
            "mma_sync": _sub(src, (_WGMMA_C, _NO_WGMMA)),
            "atomics": _sub(src, (_ADD, _ADD_ATOMICS)),
            "stages2": _sub(src, (_STAGES, _STAGES2)),
            "wg1": _sub(src, (_WGS, _WGS.replace("3", "1"))),
            "wg2": _sub(src, (_WGS, _WGS.replace("3", "2")))}


def _build(texts: dict[str, str]) -> dict:
    """Compile every variant at once; returns {name: (entry, ptxas lines of
    the C = 64 bf16 instantiations)}."""
    out_dir = fk.BUILD_DIR / "bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [fk._nvcc(), *fk.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        ptxas = [" | ".join(ln.strip() for ln in lines[i + 1:i + 3])
                 for i, ln in enumerate(lines)
                 if "Function properties" in ln
                 and ("bwd_wgmmaILi64E" in ln or "bwd_bf16ILi64E" in ln)]
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_bwd
        fn.argtypes = fk._ENTRIES["flash_bwd"][1]
        fn.restype = ctypes.c_int
        built[name] = (fn, ptxas)
    return built


def _attn6_inputs():
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, lq, lk, c = 8, 16384, 9216, 64
    q = (torch.randn(b, lq, c, generator=gen, device="cuda")
         * c ** -0.5).bfloat16()
    k, v = (torch.randn(b, lk, c, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    do = torch.randn(b, lq, c, generator=gen, device="cuda").bfloat16()
    mask = torch.rand(b, lq, generator=gen, device="cuda") < 0.5
    bias = fa.mask_to_bias(fa.plan_compaction(mask).valid, b, lk)
    return q, k, v, bias, do


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ab: no CUDA device; this tool runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    built = _build(variants(fk.SOURCES["flash_bwd"].read_text()))
    for name, (_, ptxas) in built.items():
        print(json.dumps({"variant": name, "ptxas_c64_bf16": ptxas}),
              flush=True)

    q, k, v, bias, do = _attn6_inputs()
    o, lse = fk.flash_fwd_nomax_reference(q, k, v, bias, 1.0, False,
                                          with_lse=True)
    delta = fk._delta(o, do)
    want = fk.flash_bwd_reference(q, k, v, bias, o, lse, do, 1.0, False)
    b, lq, c = q.shape
    qmul = fk.weak_scalar(fk._LOG2E, torch.bfloat16)

    def run(fn):
        dq = torch.zeros(b, lq, c, device="cuda")
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq,
                 k.shape[1], c, 1, 0, 1, qmul, 1.0,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd variant: CUDA error {err}")
        return dq.bfloat16(), dk, dv

    names = list(built)
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            fn = built[name][0]
            got = run(fn)
            torch.cuda.synchronize()
            rms = [float((g.float() - w.float()).square().mean().sqrt()
                         / w.float().square().mean().sqrt())
                   for g, w in zip(got, want)]
            best = float("inf")
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    run(fn)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 10)
            print(json.dumps({"round": rnd, "variant": name,
                              "attn6_ms": best,
                              "rms_err_over_rms_plain_dq_dk_dv": rms}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
