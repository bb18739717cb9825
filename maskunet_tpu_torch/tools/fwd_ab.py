"""A/B of variants of a forward kernel source on the card: the forward's
counterpart of `bwd_ab` (the JAX package's is tools/fwd_sweep.py).

`--source nomax` (the default) takes K1/K2's source, which also holds
the tools' K6 (csrc/flash_fwd_nomax.cu), `--source online` K3's, which
also holds K5 and K7 (csrc/flash_fwd_online.cu). Each variant is the
committed source with one text substitution, built with the library's
own nvcc flags, held against the plain version and timed with CUDA
events through the C entries (K1's and K6's repack and kernel, or K3's,
K5's and K7's), in alternating order over the rounds, at three shapes of
the ADE serving forward (batch 8, bf16; K5, K6 D and E and K7 at attn6
only, on their tools' inputs):

  attn6   16,384 queries x 9,216 compacted key slots, C 64, no use_valid
  attn1   4,096 queries x 2,560 compacted key slots, C 128, no use_valid
  attn2   1,024 queries x 1,024 keys, C 256, use_valid

    python -m maskunet_tpu_torch.tools.fwd_ab [--source online] [--rounds 2]

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

K6 runs K1's wgmma body at C 64 in every variant but `mma_sync` (it has
no mma.sync body), so the C 64 variants apply to it too (but `pingpong`:
K6 takes turns at the tensor cores in the source), and one more:
  k6_no_pingpong  K6 without ping-pong (K1's choice at C 64)
  k6e_uncapped    K6's E takes exp2 of its scores as they are, not capped
                  at 128 (the same results: exp2 is +inf from 128 on)

Variants of the online source (K3, K5 and K7 run K1's wgmma body with
the running max; unlike K1's source it takes turns at the tensor cores at
C 64 too):
  source, mma_sync, producer0, c128_no_pingpong, stages3  as above
  c64_no_pingpong  no ping-pong at C 64 (K1's choice there)
  keys64           as above; for K7 that is its key tile, so its row is
                   held against the plain version at the source's 128
  k5_expf          K5's p = __expf(s - m), a subtract and a multiply a
                   score, in place of ex2 of one FMA

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
from maskunet_tpu_torch.tools import bf16_softmax_experiment as bf16_tool
from maskunet_tpu_torch.tools import softmax_ab

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
_PINGPONG64_ON = "constexpr bool kPingPong64 = true;"
_EXP_BY_FMA = "constexpr bool kExpByFma = true;"
_PINGPONG_K6 = "constexpr bool kPingPongK6 = true;"
_E_CAP = "(s > kExp2Inf ? kExp2Inf : s)"


def _on(line: str, old: str, new: str) -> tuple[str, str]:
    return line, line.replace(old, new)


# name -> the substitutions that make the variant from the source
_SUBS = {
    "source": (),
    "mma_sync": ((_WGMMA_C, _NO_WGMMA),),
    "c256_mma_sync": ((_WGMMA_C, _WGMMA_C_NO256),),
    "producer0": (_on(_PRODUCER, "true", "false"),),
    "pingpong": (_on(_PINGPONG, "false", "true"),),
    "c128_no_pingpong": (_on(_PINGPONG128, "true", "false"),),
    "stages2": (_on(_STAGES, "= 4", "= 2"),),
    "stages3": (_on(_STAGES, "= 4", "= 3"),),
    "keys64": (_on(_KEYS, "= 128", "= 64"),),
    "keys256": (_on(_KEYS, "= 128", "= 256"), _on(_STAGES, "= 4", "= 2")),
    "wg3": (_on(_WGS, "= 2", "= 3"),),
    "c128_keys128": (_on(_KEYS128, "= 64", "= 128"),
                     _on(_STAGES128, "= 4", "= 2")),
    "c64_no_pingpong": (_on(_PINGPONG64_ON, "true", "false"),),
    "k5_expf": (_on(_EXP_BY_FMA, "true", "false"),),
    "k6_no_pingpong": (_on(_PINGPONG_K6, "true", "false"),),
    "k6e_uncapped": ((_E_CAP, "s"),),
}
NOMAX_VARIANTS = ("source", "mma_sync", "c256_mma_sync", "producer0",
                  "pingpong", "c128_no_pingpong", "stages2", "stages3",
                  "keys64", "keys256", "wg3", "c128_keys128",
                  "k6_no_pingpong", "k6e_uncapped")
ONLINE_VARIANTS = ("source", "mma_sync", "producer0", "c64_no_pingpong",
                   "c128_no_pingpong", "stages3", "keys64", "k5_expf")


def _sub(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"the kernel source no longer holds {old!r} "
                             "once")
        text = text.replace(old, new)
    return text


def variants(src: str, names=NOMAX_VARIANTS) -> dict[str, str]:
    """{name: CUDA source} of the variants `names` of the module
    docstring."""
    return {name: _sub(src, *_SUBS[name]) for name in names}


# source -> (library, C entries a variant is timed through, kernels whose
# ptxas lines are printed: the C = 64 bf16 instantiations)
_LIBRARIES = {
    "nomax": ("flash_fwd_nomax",
              ("flash_fwd_nomax", "flash_repack65", "flash_fwd_nomax65"),
              ("fwd_nomax_wgmmaILi64E", "fwd_nomax_bf16ILi64E")),
    "online": ("flash_fwd_online",
               ("flash_fwd_online", "flash_fwd_online_exp",
                "flash_fwd_online_bf16"),
               ("fwd_online_wgmmaILi64E", "fwd_online_bf16ILi64E")),
}


def _build(texts: dict[str, str], source: str) -> dict:
    """Compile every variant at once; returns {name: ({entry: function},
    ptxas lines of the C = 64 bf16 instantiations)}."""
    _, entries, kernels = _LIBRARIES[source]
    out_dir = fk.BUILD_DIR / f"fwd_ab_{source}"
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
                 and any(kn in ln for kn in kernels)]
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fns = {}
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = fk._ENTRIES[entry][1]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        built[name] = (fns, ptxas)
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


def _check_err(entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} variant: CUDA error {err}")


def _call_k6(fns: dict, q65, k65, v, clamp):
    """o of K6 (D with `clamp`, else E) through a variant's entries: its
    repack of q65 and k65 into a workspace, then its kernel."""
    stream = torch.cuda.current_stream().cuda_stream
    b, lq, _ = q65.shape
    lk = k65.shape[1]
    parts = []
    for x65 in (q65, k65):
        x64 = torch.empty(*x65.shape[:2], 64, dtype=x65.dtype,
                          device=x65.device)
        xa = torch.empty(x65.shape[:2], device=x65.device)
        _check_err("flash_repack65", fns["flash_repack65"](
            x65.data_ptr(), x64.data_ptr(), xa.data_ptr(), *x65.shape[:2],
            stream))
        parts += [x64.data_ptr(), xa.data_ptr()]
    o = torch.empty(b, lq, 64, dtype=v.dtype, device=v.device)
    _check_err("flash_fwd_nomax65", fns["flash_fwd_nomax65"](
        *parts, v.data_ptr(), o.data_ptr(), b, lq, lk, int(clamp), stream))
    return o


def _call(entry: str, fns: dict, *inputs):
    """o of one call of a variant's C `entry` (K1's, K3's, K5's, K6's or
    K7's) on bf16 inputs, scale 1: (q, k, v, bias, use_valid), or for K6
    (q65, k65, v, clamp)."""
    if entry == "flash_fwd_nomax65":
        return _call_k6(fns, *inputs)
    q, k, v, bias, uv = inputs
    o = torch.empty_like(q)
    b, lq, c = q.shape
    lse = torch.empty(b, 1, lq, device=q.device)
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr()]
    if entry != "flash_fwd_nomax":
        head.append(lse.data_ptr())
    tail = [b, lq, k.shape[1], c]
    if entry in ("flash_fwd_nomax", "flash_fwd_online"):
        tail += [1, int(uv), fk.weak_scalar(fk._LOG2E, torch.bfloat16)]
    _check_err(entry, fns[entry](*head, *tail,
                                 torch.cuda.current_stream().cuda_stream))
    return o


def _cases(source: str) -> dict:
    """{label: (entry, inputs, the plain version's o)} the variants of
    `source` are timed at."""
    shapes = {"attn6": _inputs(16384, 64, False, 0),
              "attn1": _inputs(4096, 128, False, 2),
              "attn2": _inputs(1024, 256, True, 1)}
    tool = softmax_ab.attn6_inputs(8)
    if source == "nomax":
        cases = {s: ("flash_fwd_nomax", x,
                     fk.flash_fwd_nomax_reference(*x[:4], 1.0, x[4]))
                 for s, x in shapes.items()}
        x6 = (*softmax_ab.bias_as_channel(*tool[:2], tool[3]), tool[2])
        for label, clamp in (("k6_attn6", True), ("k6e_attn6", False)):
            cases[label] = ("flash_fwd_nomax65", (*x6, clamp),
                            softmax_ab.nomax65_fwd_reference(*x6, clamp))
        return cases
    cases = {s: ("flash_fwd_online", x,
                 fk.flash_fwd_online_reference(*x[:4], 1.0, x[4])[0])
             for s, x in shapes.items()}
    cases["k5_attn6"] = ("flash_fwd_online_exp", (*tool, False),
                         softmax_ab.old_flash_fwd_reference(*tool)[0])
    x7 = (*bf16_tool.attn6_inputs(8), False)
    cases["k7_attn6"] = ("flash_fwd_online_bf16", x7,
                         bf16_tool.flash_fwd_bf16_reference(*x7[:4])[0])
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=tuple(_LIBRARIES), default="nomax")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_ab: no CUDA device; this tool runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = fk.SOURCES[_LIBRARIES[args.source][0]].read_text()
    names = NOMAX_VARIANTS if args.source == "nomax" else ONLINE_VARIANTS
    built = _build(variants(src, names), args.source)
    for name, (_, ptxas) in built.items():
        print(json.dumps({"source": args.source, "variant": name,
                          "ptxas_c64_bf16": ptxas}), flush=True)
    cases = _cases(args.source)

    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            fns = built[name][0]
            row = {"source": args.source, "round": rnd, "variant": name}
            for label, (entry, inputs, want) in cases.items():
                got = _call(entry, fns, *inputs)
                torch.cuda.synchronize()
                w = want.float()
                row[f"{label}_rms_err_over_rms_plain"] = float(
                    (got.float() - w).square().mean().sqrt()
                    / w.square().mean().sqrt())
                best = float("inf")
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(20):
                        _call(entry, fns, *inputs)
                    end.record()
                    end.synchronize()
                    best = min(best, start.elapsed_time(end) / 20)
                row[f"{label}_ms"] = best
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
