"""A/B of variants of the K4 source (csrc/flash_bwd.cu) on the card.

Each variant is the committed source with one text substitution, built
with the library's own nvcc flags, held against the plain version and
timed at attn6 of the ADE training step (batch 8, Lq 16,384, 9,216
compacted key slots, C 64, bf16) with CUDA events, in alternating order
over the rounds. A time includes the zeroing of dQ, as the wrapper's call
does.

    python -m maskunet_tpu_torch.tools.bwd_ab [--rounds 2]

Variants:
  source          the committed kernel (dQ by float2 atomicAdd)
  scalar_atomics  dQ by one f32 atomicAdd per channel
  no_atomics      dQ computed but never added (wrong dQ: timing only)
  bq32            32 queries a step at C = 64 (half the S^T/dP^T registers)
  bq32_2blocks    bq32 with __launch_bounds__(256, 2): two blocks an SM

It prints one JSON line per variant built (ptxas's registers and spills
of the C = 64 instantiations) and per variant timed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from maskunet_tpu_torch.ops import flash_attention as fa
from maskunet_tpu_torch.ops import flash_kernels as fk

_FLOAT2 = """\
        if (r0 < lq)
          atomicAdd(reinterpret_cast<float2*>(dqb + size_t(r0) * C + col),
                    make_float2(scale * dqa[n][0], scale * dqa[n][1]));
        if (r1 < lq)
          atomicAdd(reinterpret_cast<float2*>(dqb + size_t(r1) * C + col),
                    make_float2(scale * dqa[n][2], scale * dqa[n][3]));"""
_SCALAR = """\
        if (r0 < lq) {
          atomicAdd(dqb + size_t(r0) * C + col, scale * dqa[n][0]);
          atomicAdd(dqb + size_t(r0) * C + col + 1, scale * dqa[n][1]);
        }
        if (r1 < lq) {
          atomicAdd(dqb + size_t(r1) * C + col, scale * dqa[n][2]);
          atomicAdd(dqb + size_t(r1) * C + col + 1, scale * dqa[n][3]);
        }"""
# a store that never runs but keeps the dQ products alive
_NONE = ("        if (r0 < 0) dqb[col] = dqa[n][0] + dqa[n][1] + dqa[n][2]"
         " + dqa[n][3];")
_BQ = "    constexpr int BQ = C == 64 ? 64 : 32;"
_BQ32 = "    constexpr int BQ = 32;"
_BOUNDS = "__global__ void __launch_bounds__(32 * KW * CS, 1)"
_BOUNDS2 = "__global__ void __launch_bounds__(32 * KW * CS, C == 64 ? 2 : 1)"


def _sub(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"the K4 source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def variants(src: str) -> dict[str, str]:
    """{name: CUDA source} of the variants of the module docstring."""
    return {"source": _sub(src),
            "scalar_atomics": _sub(src, (_FLOAT2, _SCALAR)),
            "no_atomics": _sub(src, (_FLOAT2, _NONE)),
            "bq32": _sub(src, (_BQ, _BQ32)),
            "bq32_2blocks": _sub(src, (_BQ, _BQ32), (_BOUNDS, _BOUNDS2))}


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
                 if "Function properties" in ln and "bwd_bf16ILi64E" in ln]
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
