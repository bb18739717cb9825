"""A/B of the optimizer-update segment of the train step on the card.

Counterpart of tools/opt_ab.py: the whole train step of the ADE model
(c_out 150, 128 px, batch 8, bf16, precomputed plans) under each arm, in
one process, best of 3 interleaved rounds of `steps` steps:

  adamw       torch AdamW 5e-5, weight decay 0.1 (optax's betas and eps,
              `train.loop.AdamW`): the port's optimizer
  adamw_bf16  `AdamWBf16Mu`: optax.adamw(5e-5, weight_decay=0.1,
              mu_dtype=bfloat16): the first moment stored in bf16 (half
              its bytes); the update uses the f32 moment and the moment
              is rounded to bf16 after, as optax casts it
  sgd         plain SGD 5e-5: the floor of the update segment
  bwd_bf16    not applicable: JAX's arm stores K4's dQ partial blocks in
              bf16 (MASKUNET_BWD_PARTIALS_BF16); the port's K4 reduces dQ
              in f32 by bulk tensor adds (csrc/flash_bwd.cu) and has no
              partials stream. The tool prints the arm with this reason.

    python -m maskunet_tpu_torch.tools.opt_ab [batch] [steps-per-trial]
        [--device cuda|cpu]

The AdamW segment is adamw − sgd. The steps are
`train_breakdown.make_step_call`'s, timed by `fwd_breakdown.interleaved`;
the card's kernel time a step (`utils/profiling.device_ms_per_call`)
stands beside each wall time. `AdamWBf16Mu` keeps its moments in flat
buffers (one concatenation of the gradients a step, one multi-tensor add
into the parameters): its launches are not torch AdamW's, so the arm
measures that implementation, not the moment's dtype alone. A host
without CUDA is refused unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses

from maskunet_tpu_torch.tools.fwd_breakdown import device_suffix, interleaved
from maskunet_tpu_torch.tools.train_breakdown import SGD, make_step_call

BWD_BF16_NOTE = ("not applicable: K4 reduces dQ in f32 by bulk tensor adds "
                 "and has no partials stream to store in bf16")


class AdamWBf16Mu:
    """optax.adamw(lr, b1, b2, eps, weight_decay=wd, mu_dtype=bfloat16)
    over a list of f32 parameters, updated in place by `step()` from their
    `.grad`. Per optax (`scale_by_adam`, `add_decayed_weights`,
    `scale_by_learning_rate`): mu = (1 − b1)·g + b1·mu, with b1·mu a bf16
    product (JAX rounds the Python scalar to bf16 and multiplies in bf16)
    and the sum in f32; nu = (1 − b2)·g² + b2·nu in f32; the update
    −lr·(mu/(1 − b1ᵗ) / (sqrt(nu/(1 − b2ᵗ)) + eps) + wd·p) from the f32
    mu, which is then stored rounded to bf16."""

    def __init__(self, params, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        import torch

        self.params = list(params)
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            lr, weight_decay, b1, b2, eps)
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.mu = torch.zeros(n, dtype=torch.bfloat16, device=dev)
        self.nu = torch.zeros(n, device=dev)
        self.count = 0

    def step(self) -> None:
        import torch

        from maskunet_tpu_torch.core.layers import weak_scalar

        with torch.no_grad():
            g = torch.cat([p.grad.reshape(-1) for p in self.params])
            flat = torch.cat([p.reshape(-1) for p in self.params])
            self.count += 1
            mu = g * (1 - self.b1) + self.mu * weak_scalar(self.b1,
                                                           torch.bfloat16)
            self.nu = g * g * (1 - self.b2) + self.nu * self.b2
            f32 = torch.tensor(1.0, device=g.device)
            mu_hat = mu / (1 - (f32 * self.b1) ** self.count)
            nu_hat = self.nu / (1 - (f32 * self.b2) ** self.count)
            upd = (mu_hat / (torch.sqrt(nu_hat) + self.eps)
                   + self.wd * flat) * -self.lr
            self.mu = mu.to(torch.bfloat16)
            torch._foreach_add_(self.params, [
                u.view_as(p) for u, p in zip(
                    upd.split([p.numel() for p in self.params]),
                    self.params)])

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None


@dataclasses.dataclass(frozen=True)
class AdamWBf16:
    """An optimizer factory as `train.loop.AdamW`: `AdamWBf16Mu`."""
    lr: float
    weight_decay: float

    def __call__(self, params) -> AdamWBf16Mu:
        return AdamWBf16Mu(params, self.lr, self.weight_decay)

    def scheduler(self, optimizer):
        return None


def arms() -> dict:
    from maskunet_tpu_torch.train import loop as loop_lib

    return {"adamw": loop_lib.AdamW(5e-5, 1e-1),
            "adamw_bf16": AdamWBf16(5e-5, 1e-1), "sgd": SGD(5e-5)}


def run(batch: int = 8, steps: int = 15, *, img_size: int = 128,
        device: str = "cuda", rounds: int = 3,
        device_calls: int = 3) -> dict:
    """The arms' steps, best of `rounds` interleaved windows; prints the
    JAX tool's lines with device ms. Returns {arm: {"ms", "best_ms", ...}}
    and the segment."""
    calls = {name: make_step_call("full", batch, img_size=img_size,
                                  device=device, tx=tx, mask_plans=True)
             for name, tx in arms().items()}
    res = interleaved(calls, float, steps, rounds=rounds,
                      device_calls=device_calls)
    base = res["adamw"]["best_ms"]
    print(f"batch {batch}, best of {rounds} x {steps} steps:")
    for name, r in res.items():
        dt = r["best_ms"]
        print(f"  {name:10s}: {dt:7.2f} ms/step "
              f"({batch / dt * 1e3:6.1f} img/s)  {base / dt:5.3f}x vs adamw"
              f"{device_suffix(r['device_ms'])}")
    print(f"  {'bwd_bf16':10s}: {BWD_BF16_NOTE}")
    seg = res["adamw"]["best_ms"] - res["sgd"]["best_ms"]
    dev = (None if res["adamw"]["device_ms"] is None
           or res["sgd"]["device_ms"] is None
           else res["adamw"]["device_ms"] - res["sgd"]["device_ms"])
    print(f"\n  AdamW update segment (adamw - sgd): {seg:5.2f} ms"
          f"{device_suffix(dev)}")
    return {**res, "segment_ms": seg, "segment_device_ms": dev}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="opt_ab")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("steps", type=int, nargs="?", default=15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("opt_ab", args.device)
    return run(args.batch, args.steps, device=args.device)


if __name__ == "__main__":
    main()
