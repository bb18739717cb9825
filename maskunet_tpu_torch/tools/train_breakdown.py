"""Ablation breakdown of the training step (forward, backward, AdamW) on
the card.

Counterpart of tools/train_breakdown.py: a same-process A/B with attention
layers removed, the train mIoU, the loss, BatchNorm's batch statistics or
GELU stubbed out, dropout off, or SGD for AdamW, to locate the step's time.

    python -m maskunet_tpu_torch.tools.train_breakdown [batch] [mode,mode,...]
        [--device cuda|cpu]

The step is the JAX tool's: the ADE model (c_out 150, 128 px, bf16), the
train step with AdamW 5e-5 / decay 0.1 and the default TaskConfig, the
masks in the state (planned in each step, as JAX's step plans them), on
one random batch. A second argument names the modes to run after
'full'. The patches (`fwd_breakdown.patched`):

- noattn / no16k / no4k: `ops.attention.spatial_attention`;
- nomiou: `ops.metrics_ops.mean_iou` returns 0;
- noce: `train.step.cross_entropy` (imported there by name) is the mean
  logit, so the backward still spans the model;
- nobnstat: `core.layers.batchnorm_train` (the port's train BatchNorm)
  normalises with the running statistics and keeps them (JAX patches
  `batchnorm` with train=False);
- nogelu: `core.layers.gelu` is the identity;
- nodrop: dropout 0; sgd: `torch.optim.SGD(lr=5e-5)` for AdamW.

The numbers-changing modes are cost probes only. Each patch stays in place
through the warm-up step, the timed windows (best of 3 x 15 steps, fenced
by a fetch of the loss: `fwd_breakdown.timeit`) and the device-time calls,
and is restored after them, also after an exception. The device ms of a
step (`utils/profiling.device_ms_per_call`) stands beside each wall time:
the eager step at 128 px is host-bound. A host without CUDA is refused
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses

from maskunet_tpu_torch.tools.fwd_breakdown import (attention_for,
                                                    device_suffix, patched,
                                                    timeit)

MODES = ("full", "noattn", "no16k", "no4k", "nodrop", "nomiou", "noce",
         "nobnstat", "nogelu", "sgd")


@dataclasses.dataclass(frozen=True)
class SGD:
    """An optimizer factory as `train.loop.AdamW`: plain SGD at `lr`."""
    lr: float

    def __call__(self, params):
        import torch
        return torch.optim.SGD(params, lr=self.lr)

    def scheduler(self, optimizer):
        return None


def mode_patches(mode: str) -> list:
    """(module, name, value) patches of `mode`: the attention dispatch
    always (the identity for the layers the mode names), and the stub the
    mode names."""
    from maskunet_tpu_torch.core import layers
    from maskunet_tpu_torch.ops import attention, metrics_ops
    from maskunet_tpu_torch.train import step as step_lib

    out = [(attention, "spatial_attention",
            attention_for(mode if mode in ("noattn", "no16k", "no4k")
                          else "full", attention.spatial_attention))]
    if mode == "nomiou":
        out.append((metrics_ops, "mean_iou",
                    lambda lg, lb, c, **kw: lg.new_zeros(()).float()))
    if mode == "noce":    # a trivial loss head; the backward still spans
        out.append((step_lib, "cross_entropy",
                    lambda lg, lb, ig=None, group=None: lg.mean()))
    if mode == "nobnstat":   # running-stats BN: the batch statistics' cost
        bn = layers.batchnorm

        def running_stats(w, b, mean, var, x, **kw):
            return bn(w, b, mean, var, x), mean, var

        out.append((layers, "batchnorm_train", running_stats))
    if mode == "nogelu":
        out.append((layers, "gelu", lambda x: x))
    return out


def make_step_call(mode: str, batch: int, *, img_size: int = 128,
                   device: str = "cuda", tx=None, mask_plans: bool = False,
                   remat: bool = False, dtype: str = "bfloat16",
                   seed: int = 0):
    """The JAX tools' train step as a call that returns the loss: the ADE
    model at `img_size` in `dtype` from `seed` (weights `seed`, masks
    `seed` + 1, the state's generator `seed` + 2), one random batch, `tx`
    (default: SGD 5e-5 in mode 'sgd', else AdamW 5e-5 / 0.1), the masks
    in the state and planned in each step unless `mask_plans` (then
    planned once, `precompute_mask_plans`), `remat_attention` if `remat`,
    dropout 0 in mode 'nodrop'. Call it inside `mode_patches(mode)`."""
    import numpy as np
    import torch

    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib

    dev = resolve_device(device)
    cfg = mu.MaskAttnUNetConfig(
        c_out=150, img_size=img_size, compute_dtype=dtype,
        remat_attention=remat,
        dropout_rate=0.0 if mode == "nodrop" else 0.3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, img_size, img_size, 3)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.integers(0, 150, (batch, img_size, img_size))).to(dev)
    batch_data = {"image": x, "label": labels}
    if tx is None:
        tx = SGD(5e-5) if mode == "sgd" else loop_lib.AdamW(5e-5, 1e-1)
    params, mstate = mu.init(torch.Generator().manual_seed(seed), cfg)
    masks = tuple(m.to(dev) for m in mu.make_attention_masks(
        torch.Generator().manual_seed(seed + 1), batch, img_size))
    ts = state_lib.create(torch.Generator(device=dev).manual_seed(seed + 2),
                          {k: v.to(dev) for k, v in params.items()},
                          {k: v.to(dev) for k, v in mstate.items()},
                          tx, masks=masks)
    train_step = step_lib.make_train_step(
        cfg, step_lib.TaskConfig(),
        mask_plans=mu.precompute_mask_plans(masks) if mask_plans else None,
        device=dev)

    def step():
        return train_step(ts, batch_data)[1]["loss"]

    return step


def timed_step(mode: str, batch: int, *, steps: int = 15, repeats: int = 3,
               device_calls: int = 3, img_size: int = 128,
               device: str = "cuda") -> dict:
    """One mode: a fresh state, its patches, one warm step, the timed
    windows and the device time; returns the wall and device ms a step and
    the last loss."""
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    with patched(*mode_patches(mode)):
        step = make_step_call(mode, batch, img_size=img_size, device=device)
        sec = timeit(step, float, steps=steps, repeats=repeats)
        dev_ms = device_ms_per_call(step, calls=device_calls)
        loss = float(step())
    return {"ms": sec * 1e3, "device_ms": dev_ms, "loss": loss}


def run(batch: int = 8, modes=MODES, **kw) -> dict:
    """Times each mode (`timed_step`'s keywords: the windows, the device
    calls, the image size, the device); prints the JAX tool's lines with
    the device ms beside. Returns {mode: {"ms", "device_ms", "loss"}}."""
    results = {}
    for mode in modes:
        r = timed_step(mode, batch, **kw)
        results[mode] = r
        print(f"{mode:8s} {r['ms']:7.2f} ms/step  "
              f"({batch / r['ms'] * 1e3:6.1f} img/s)  loss={r['loss']:.4f}"
              f"{device_suffix(r['device_ms'])}", flush=True)

    full = results.get("full")

    def delta(name, label):
        if name in results and full is not None:
            r = results[name]
            d_dev = (None if r["device_ms"] is None
                     or full["device_ms"] is None
                     else full["device_ms"] - r["device_ms"])
            print(f"{label:19s}: {full['ms'] - r['ms']:6.2f} ms"
                  f"{device_suffix(d_dev)}")

    delta("noattn", "attn total fwd+bwd")
    delta("no16k", "attn6 fwd+bwd")
    delta("no4k", "attn1/5 fwd+bwd")
    if "noattn" in results:
        r = results["noattn"]
        print(f"conv+opt (noattn)  : {r['ms']:6.2f} ms"
              f"{device_suffix(r['device_ms'])}")
    delta("nodrop", "dropout cost")
    delta("nomiou", "train-miou cost")
    delta("noce", "CE loss cost")
    delta("nobnstat", "BN batch-stat cost")
    delta("nogelu", "GELU cost")
    delta("sgd", "AdamW-over-SGD cost")
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="train_breakdown")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("modes", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("train_breakdown", args.device)
    modes = MODES if args.modes is None else ["full"] + args.modes.split(",")
    return run(args.batch, modes, device=args.device)


if __name__ == "__main__":
    main()
