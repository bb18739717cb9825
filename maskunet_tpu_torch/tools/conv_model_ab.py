"""In-model same-process A/B: the direct conv against im2col for the UNet
trunk, on the card.

Counterpart of tools/conv_model_ab.py. `conv_ab` times each conv alone,
where a call is a launch or two and its wall time is mostly the host's;
this tool times the whole folded forward (and with `--train` the train
step, AdamW 5e-5 / 0.1) twice: with the port's conv (`core.layers.conv2d`,
cuDNN) and with `layers.conv2d` patched to `conv_ab.conv_im2col` for the
3x3 convs (the nine taps concatenated into one [B*H*W, 9*Cin] @ [9*Cin,
Cout] matmul; the 1x1 heads keep the direct conv). The patch
(`fwd_breakdown.patched`) holds through every warm-up, timed and device
call of the im2col arm and is restored after each, also after an
exception.

The ADE model: c_out 150, 128 px, batch 8, bf16, weights from seed 0,
cached masks from seed 1 (with their plans for the forward; planned in
the step, as JAX's tool passes no plans there). Best of 3 interleaved
rounds of 20 calls (`fwd_breakdown.interleaved`), the card's kernel time
a call beside (`utils/profiling.device_ms_per_call`).

    python -m maskunet_tpu_torch.tools.conv_model_ab [batch] [--train]
        [--device cuda|cpu]

A host without CUDA is refused unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.conv_ab import conv_im2col
from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor,
                                                    inference_setup,
                                                    interleaved,
                                                    make_forward, patched)
from maskunet_tpu_torch.tools.train_breakdown import make_step_call


def im2col_conv2d(direct):
    """`layers.conv2d` with its 3x3 convs as `conv_im2col`; the others go
    to `direct`."""
    def conv2d(weight, bias, x):
        if weight.shape[-2:] != (3, 3):
            return direct(weight, bias, x)
        return conv_im2col(x, weight, bias).to(x.dtype)

    return conv2d


def with_im2col(fn):
    """`fn` as a call that runs with `layers.conv2d` patched to
    `im2col_conv2d` (restored after each call, also after an
    exception)."""
    from maskunet_tpu_torch.core import layers

    def call():
        with patched((layers, "conv2d", im2col_conv2d(layers.conv2d))):
            return fn()

    return call


def _report(what: str, res: dict, batch: int) -> None:
    td, ti = res["direct"]["best_ms"], res["im2col"]["best_ms"]
    print(f"batch={batch} {what}: direct {td:.2f} ms "
          f"({batch / td * 1e3:.1f} img/s)  im2col {ti:.2f} ms "
          f"({batch / ti * 1e3:.1f} img/s)  ratio {td / ti:.3f}")
    print(f"  direct{device_suffix(res['direct']['device_ms'])}  im2col"
          f"{device_suffix(res['im2col']['device_ms'])}", flush=True)


def run(batch: int = 8, train: bool = False, *, img_size: int = 128,
        device: str = "cuda", steps: int = 20, rounds: int = 3,
        device_calls: int = 3) -> dict:
    """The forward A/B (and the step's with `train`); prints the JAX
    tool's lines with device ms. Returns {"rel_err", "forward", "train"}."""
    from maskunet_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    setup = inference_setup(batch, img_size, dev)
    fwd = make_forward(*setup)
    fwd_i = with_im2col(fwd)
    yd = fwd().float()
    yi = fwd_i().float()
    err = float((yd - yi).abs().max() / max(float(yd.abs().max()), 1e-6))
    print(f"forward rel-err direct vs im2col: {err:.2e}")
    res = {"rel_err": err,
           "forward": interleaved({"direct": fwd, "im2col": fwd_i},
                                  fence_tensor, steps, rounds=rounds,
                                  device_calls=device_calls)}
    _report("forward", res["forward"], batch)
    if train:
        step_d = make_step_call("full", batch, img_size=img_size,
                                device=device)
        step_i = make_step_call("full", batch, img_size=img_size,
                                device=device)
        res["train"] = interleaved(
            {"direct": step_d, "im2col": with_im2col(step_i)},
            float, steps, rounds=rounds, device_calls=device_calls)
        _report("train", res["train"], batch)
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="conv_model_ab")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("conv_model_ab", args.device)
    return run(args.batch, args.train, device=args.device)


if __name__ == "__main__":
    main()
