"""A/B of variants of the K1/K2 source (csrc/flash_fwd_nomax.cu) on the
card: the forward's counterpart of `bwd_ab` (the JAX package's is
tools/fwd_sweep.py).

Each variant is the committed source with one text substitution, built
with the library's own nvcc flags, held against the plain version and
timed with CUDA events through K1's C entry, in alternating order over
the rounds, at three shapes of the ADE serving forward (batch 8, bf16):

  attn6   16,384 queries x 9,216 compacted key slots, C 64, no use_valid
  attn1   4,096 queries x 2,560 compacted key slots, C 128, no use_valid
  attn2   1,024 queries x 1,024 keys, C 256, use_valid

    python -m maskunet_tpu_torch.tools.fwd_ab [--rounds 2]

Variants (bf16 runs the wgmma body at every C unless named otherwise):
  source     the committed kernel (wgmma, a producer warpgroup and two
             consumer warpgroups of 64 queries a block, one at C 256; a
             four-stage TMA ring, three at C 256; 128 keys a step at C 64
             and 64 above; ping-pong at C 128)
  mma_sync   the mma.sync body (the source keeps it for a call with no
             key) at every C: the kernel before the wgmma body
  c256_mma_sync  the mma.sync body at C = 256 only
  producer0  no producer warpgroup: thread 0 refills each stage after its
             own step (the first wgmma design's loads)
  pingpong   at C 64 the consumer warpgroups take turns at the tensor
             cores (named barriers), so that one's softmax overlaps the
             other's products, as the source does at C 128
  c128_no_pingpong  no ping-pong at C 128
  stages2    a two-stage K / V ring at C 64
  stages3    a three-stage K / V ring at C 64
  keys64     64 keys a step at C 64 (m64n64k16 scores)
  keys256    256 keys a step at C 64 (two m64n128k16 score products) and
             a two-stage ring (shared memory holds no more)
  wg3        three consumer warpgroups (192 queries) a block at C 64
             and 128
  c128_keys128  128 keys a step and a two-stage ring at C 128 (shared
             memory holds no more)

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
            "{ return c == 64 || c == 128 || c == 256; }")
_WGMMA_C_NO256 = ("constexpr bool wgmma_body(int c) "
                  "{ return c == 64 || c == 128; }")
_NO_WGMMA = "constexpr bool wgmma_body(int c) { return false; }"
_PRODUCER = "constexpr bool kProducerWarp = true;"
_PINGPONG = "constexpr bool kPingPong64 = false;"
_PINGPONG128 = "constexpr bool kPingPong128 = true;"
_STAGES = "constexpr int kStages64 = 4;"
_KEYS = "constexpr int kKeys64 = 128;"
_WGS = "constexpr int kConsumers = 2;"
_KEYS128 = "constexpr int kKeys128 = 64;"
_STAGES128 = "constexpr int kStages128 = 4;"


def _sub(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"the K1/K2 source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def variants(src: str) -> dict[str, str]:
    """{name: CUDA source} of the variants of the module docstring."""
    return {"source": _sub(src),
            "mma_sync": _sub(src, (_WGMMA_C, _NO_WGMMA)),
            "c256_mma_sync": _sub(src, (_WGMMA_C, _WGMMA_C_NO256)),
            "producer0": _sub(src, (_PRODUCER, _PRODUCER.replace("true",
                                                                "false"))),
            "pingpong": _sub(src, (_PINGPONG, _PINGPONG.replace(
                "false", "true"))),
            "c128_no_pingpong": _sub(src, (_PINGPONG128,
                                           _PINGPONG128.replace("true",
                                                                "false"))),
            "stages2": _sub(src, (_STAGES, _STAGES.replace("= 4", "= 2"))),
            "stages3": _sub(src, (_STAGES, _STAGES.replace("= 4", "= 3"))),
            "keys64": _sub(src, (_KEYS, _KEYS.replace("= 128", "= 64"))),
            "keys256": _sub(src, (_KEYS, _KEYS.replace("= 128", "= 256")),
                            (_STAGES, _STAGES.replace("= 4", "= 2"))),
            "wg3": _sub(src, (_WGS, _WGS.replace("= 2", "= 3"))),
            "c128_keys128": _sub(
                src, (_KEYS128, _KEYS128.replace("= 64", "= 128")),
                (_STAGES128, _STAGES128.replace("= 4", "= 2")))}


def _build(texts: dict[str, str]) -> dict:
    """Compile every variant at once; returns {name: (entry, ptxas lines of
    the C = 64 bf16 instantiations)}."""
    out_dir = fk.BUILD_DIR / "fwd_ab"
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
                 and ("fwd_nomax_wgmmaILi64E" in ln
                      or "fwd_nomax_bf16ILi64E" in ln)]
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_fwd_nomax
        fn.argtypes = fk._ENTRIES["flash_fwd_nomax"][1]
        fn.restype = ctypes.c_int
        built[name] = (fn, ptxas)
    return built


def _inputs(lq: int, c: int, use_valid: bool, seed: int):
    """q (scaled by 1/sqrt(C), as the model calls the kernel), k, v and the
    bias of a Bernoulli(0.5) mask over lq tokens, batch 8, bf16; without
    use_valid the keys are compacted to the capacity buffer's slots."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.rand(8, lq, generator=gen, device="cuda") < 0.5
    if not use_valid:
        mask = fa.plan_compaction(mask).valid
    lk = mask.shape[1]
    q = (torch.randn(8, lq, c, generator=gen, device="cuda")
         * c ** -0.5).bfloat16()
    k, v = (torch.randn(8, lk, c, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, v, fa.mask_to_bias(mask, 8, lk), use_valid


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_ab: no CUDA device; this tool runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    built = _build(variants(fk.SOURCES["flash_fwd_nomax"].read_text()))
    for name, (_, ptxas) in built.items():
        print(json.dumps({"variant": name, "ptxas_c64_bf16": ptxas}),
              flush=True)

    shapes = {"attn6": _inputs(16384, 64, False, 0),
              "attn1": _inputs(4096, 128, False, 2),
              "attn2": _inputs(1024, 256, True, 1)}
    want = {s: fk.flash_fwd_nomax_reference(q, k, v, bias, 1.0, uv)
            for s, (q, k, v, bias, uv) in shapes.items()}
    qmul = fk.weak_scalar(fk._LOG2E, torch.bfloat16)

    def run(fn, q, k, v, bias, uv):
        o = torch.empty_like(q)
        b, lq, c = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 o.data_ptr(), b, lq, k.shape[1], c, 1, int(uv), qmul,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd_nomax variant: CUDA error {err}")
        return o

    names = list(built)
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            fn = built[name][0]
            row = {"round": rnd, "variant": name}
            for s, inputs in shapes.items():
                got = run(fn, *inputs)
                torch.cuda.synchronize()
                w = want[s].float()
                row[f"{s}_rms_err_over_rms_plain"] = float(
                    (got.float() - w).square().mean().sqrt()
                    / w.square().mean().sqrt())
                best = float("inf")
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(20):
                        run(fn, *inputs)
                    end.record()
                    end.synchronize()
                    best = min(best, start.elapsed_time(end) / 20)
                row[f"{s}_ms"] = best
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
