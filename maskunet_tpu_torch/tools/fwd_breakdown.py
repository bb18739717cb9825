"""Ablation breakdown of the inference forward on the card.

Counterpart of tools/fwd_breakdown.py. It patches the attention dispatch
(`ops.attention.spatial_attention`, which the model calls through its
module) to skip or re-route layers, and times each variant in one
process (a same-process A/B: separate runs differ by more than the
effects under test).

    python -m maskunet_tpu_torch.tools.fwd_breakdown [batch]
        [--device cuda|cpu]

The model is the JAX tool's: the ADE model (c_out 150, 128 px, bf16), BN
folded and cast, the cached masks. JAX's jitted forward holds the masks as
constants; here their compaction plans are computed once, before timing.

The port dispatches eagerly, so a patch must stay in place through the
warm-up, every timed call and the device-time calls; `patched` restores
it afterwards, also after an exception. The eager forward at 128 px is
host-bound, so a wall-clock delta measures Python dispatch as much as the
card: beside each wall time (best of 3 windows of 30 calls, the JAX
tool's `timeit`) the tool prints the card's kernel time a call
(`utils/profiling.device_ms_per_call`). A host without CUDA is refused
unless `--device cpu` is given (no device times there).
"""

from __future__ import annotations

import argparse
import contextlib
import time

MODES = ("full", "noattn", "no16k", "no4k", "nosmall", "dense_small")
# the token counts that name the layers at 128 px: attn6, then attn1/5
L_16K, L_4K = 16384, 4096


def timeit(fn, fence, *, steps: int = 30, repeats: int = 3) -> float:
    """Best-of-`repeats` seconds a call of `fn` over windows of `steps`
    calls, after one warm-up call; each window ends in `fence(out)`, a
    fetch to the host that waits for the card."""
    fence(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        fence(out)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def interleaved(calls: dict, fence, steps: int, rounds: int = 2,
                device_calls: int = 3) -> dict:
    """Same-process A/B: `rounds` rounds, each one `timeit` window of
    `steps` calls of every call of `calls` in turn; then the card's kernel
    time a call of each. Returns {name: {"ms": the mean over the rounds,
    "best_ms": their least, "rounds": seconds a call in each round,
    "device_ms"}}."""
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            times[name].append(timeit(fn, fence, steps=steps, repeats=1))
    return {name: {"ms": sum(t) / len(t) * 1e3, "best_ms": min(t) * 1e3,
                   "rounds": t,
                   "device_ms": device_ms_per_call(calls[name],
                                                   calls=device_calls)}
            for name, t in times.items()}


def fence_tensor(out) -> None:
    """A one-element fetch from `out`: waits for the work that made it."""
    float(out.reshape(-1)[0])


@contextlib.contextmanager
def patched(*patches):
    """Sets each (module, name, value) for the body and restores every
    original on the way out, also after an exception."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, value in patches:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def attention_for(mode: str, orig):
    """The attention dispatch of `mode`: 'full' | 'noattn' | 'no16k' |
    'no4k' | 'nosmall' (the identity for the layers it names, by their
    token count L) | 'dense_small' (dense attention for L < 4096, the
    flash path above); any other mode is `orig` for every layer."""
    def dispatch(p, xx, km, **kw):
        l = xx.shape[1] * xx.shape[2]
        if mode == "noattn":
            return xx
        if mode == "no16k" and l == L_16K:
            return xx
        if mode == "no4k" and l == L_4K:
            return xx
        if mode == "nosmall" and l < L_4K:
            return xx
        if mode == "dense_small" and l < L_4K:
            # the dense path takes no flash-only plan
            return orig(p, xx, km, **{**kw, "impl": "dense", "plan": None})
        return orig(p, xx, km, **kw)

    return dispatch


def device_suffix(device_ms) -> str:
    return ("  device not measured" if device_ms is None
            else f"  device {device_ms:7.3f} ms")


def init_model(cfg, dev):
    """The JAX tools' model: weights from seed 0 on `dev`, (params,
    BatchNorm state)."""
    import torch

    from maskunet_tpu_torch.models import maskattn_unet as mu

    params, mstate = mu.init(torch.Generator().manual_seed(0), cfg)
    return ({k: v.to(dev) for k, v in params.items()},
            {k: v.to(dev) for k, v in mstate.items()})


def inference_setup(batch: int, img_size: int, dev, *, cast: bool = True):
    """The JAX tool's inference model on `dev`: (cfg, folded params (bf16
    cast unless `cast` is False), input, masks, plans)."""
    import numpy as np
    import torch

    from maskunet_tpu_torch.models import maskattn_unet as mu

    cfg = mu.MaskAttnUNetConfig(c_out=150, img_size=img_size,
                                compute_dtype="bfloat16")
    params, mstate = init_model(cfg, dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, img_size, img_size, 3)).astype(np.float32)).to(dev)
    masks = tuple(m.to(dev) for m in mu.make_attention_masks(
        torch.Generator().manual_seed(1), batch, img_size))
    with torch.no_grad():
        p_fold = mu.fold_bn_for_inference(params, mstate, cfg)
        if cast:
            p_fold = mu.cast_params_for_inference(p_fold)
    return cfg, p_fold, x, masks, mu.precompute_mask_plans(masks)


def make_forward(cfg, p_fold, x, masks, plans, state=None):
    """The folded eval forward's semantic logits, as a call; with the
    BatchNorm `state`, the eval forward of unfolded params."""
    import torch

    from maskunet_tpu_torch.models import maskattn_unet as mu

    def fwd():
        with torch.no_grad():
            out, _ = mu.apply(p_fold, state, x, cfg=cfg, masks=masks,
                              train=False, folded=state is None,
                              mask_plans=plans)
        return out.semantic

    return fwd


def run(batch: int = 8, modes=MODES, *, steps: int = 30, repeats: int = 3,
        device_calls: int = 3, img_size: int = 128,
        device: str = "cuda") -> dict:
    """Times each mode's forward; prints the JAX tool's lines with the
    device ms beside. Returns {mode: {"ms", "device_ms"}}."""
    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.ops import attention
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    fwd = make_forward(*inference_setup(batch, img_size, dev))
    orig = attention.spatial_attention
    results = {}
    for mode in modes:
        with patched((attention, "spatial_attention",
                      attention_for(mode, orig))):
            sec = timeit(fwd, fence_tensor, steps=steps, repeats=repeats)
            dev_ms = device_ms_per_call(fwd, calls=device_calls)
        results[mode] = {"ms": sec * 1e3, "device_ms": dev_ms}
        print(f"{mode:12s} {sec * 1e3:7.2f} ms  "
              f"({batch / sec:7.1f} img/s){device_suffix(dev_ms)}",
              flush=True)

    def delta(name, label):
        if name not in results:
            return
        r, full = results[name], results["full"]
        d_dev = (None if r["device_ms"] is None or full["device_ms"] is None
                 else full["device_ms"] - r["device_ms"])
        print(f"{label}: {full['ms'] - r['ms']:6.2f} ms"
              f"{device_suffix(d_dev)}")

    if "full" in results:
        print()
        delta("noattn", "attn total  ")
        delta("no16k", "attn6 (16k) ")
        delta("no4k", "attn1/5 (4k)")
        delta("nosmall", "attn2/3/4   ")
        if "noattn" in results:
            r = results["noattn"]
            print(f"conv trunk  : {r['ms']:6.2f} ms"
                  f"{device_suffix(r['device_ms'])}")
        delta("dense_small", "dense_small delta")
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="fwd_breakdown")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("fwd_breakdown", args.device)
    return run(args.batch, device=args.device)


if __name__ == "__main__":
    main()
