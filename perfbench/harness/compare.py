"""The numbers that decide `correct`, against the plain reference.

The arithmetic here is the same for every model: the reference's readings
come from the model's module (`models/<module>.py`, `Built.reference`),
which runs its own plain reference (`reference/`).

Training (the first three steps of the window's own step and feed):

- `loss_gap`: the largest |program - reference| / |reference| of the
  three steps' losses; `loss_gap_first`: the first step's alone (steady
  where AdamW's steps at a large learning rate amplify round-off, see
  PERF.md);
- `grad_gap`: over the leaves, the largest gap between the norm of the
  program's first gradient (as AdamW holds it) and the reference's, over
  the larger of the reference leaf's norm and the median leaf's;
- `change_gap`: the same of each parameter's change after the three
  steps;
- `grad_gap_median`: the median leaf's first-gradient gap over its own
  reference norm (steady where the worst leaf and the loss swing with the
  seed, see PERF.md).

Leaves whose reference gradient is under a thousandth of the median
leaf's (a head that no loss reaches) move by weight decay alone and are
left out of both leaf numbers.
"""

from __future__ import annotations

import statistics

import torch

MOVED = 1e-3


def _exact_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _device_batch(b: dict, device) -> dict:
    out = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
    out["image"] = out["image"].float() / 255.0
    return out


def leaf_gaps(program: dict, reference: dict, keys) -> dict:
    med = statistics.median(reference.values())
    return {k: abs(program[k] - reference[k]) / max(reference[k], med)
            for k in keys}


def _worst(gaps: dict) -> tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_numbers(reference, params0: dict, batches, device, losses,
                  grad_norms, change_norms, *, quant: str | None = None,
                  half_batch: bool = False) -> dict:
    """The numbers of the program's readings against the reference's
    (`reference`: `Built.reference`; `quant="fp8"` or `half_batch`: the
    control's or the fault's reference stands in for the program's
    readings instead)."""
    _exact_f32()
    dev_batches = [_device_batch(b, device) for b in batches]
    r_losses, r_first, r_params = reference(dev_batches)
    r_grad = {k: float(v.norm()) for k, v in r_first.items()}
    r_change = {k: float((r_params[k] - params0[k]).norm())
                for k in params0}
    del r_first, r_params
    if quant is not None or half_batch:
        losses, first, params = reference(dev_batches, quant=quant,
                                          half_batch=half_batch)
        grad_norms = {k: float(v.norm()) for k, v in first.items()}
        change_norms = {k: float((params[k] - params0[k]).norm())
                        for k in params0}
    med = statistics.median(r_grad.values())
    kept = [k for k, v in r_grad.items() if v >= MOVED * med]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
    grad, grad_leaf = _worst(leaf_gaps(grad_norms, r_grad, kept))
    change, change_leaf = _worst(leaf_gaps(
        change_norms, {k: r_change[k] for k in kept}, kept))
    grad_median = statistics.median(
        abs(grad_norms[k] - r_grad[k]) / r_grad[k] for k in kept)
    return {"loss_gap": max(gaps), "loss_gap_first": gaps[0],
            "loss_gaps": gaps, "grad_gap": grad, "grad_leaf": grad_leaf,
            "grad_gap_median": grad_median,
            "change_gap": change, "change_leaf": change_leaf,
            "leaves_compared": len(kept), "leaves": len(r_grad)}
