"""Cross-entropy loss with torch semantics (mean over non-ignored pixels).

Counterpart of maskunet_tpu/losses/cross_entropy.py: `nn.CrossEntropyLoss`
(optionally with `ignore_index=255`) as every reference training loop uses
it, on NHWC logits.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int | None = None, group=None
                  ) -> torch.Tensor:
    """logits [..., C] float; labels [...] int. Mean NLL in f32 over the
    pixels whose label is >= 0 and != ignore_index (negative labels mask
    padded eval rows); the denominator is at least 1. A label >= C picks
    nothing (logit 0), as the JAX one-hot contraction does.

    `group` (the data axis): the denominator counts the pixels of every
    rank, so the result is this rank's share of the global mean (the
    local sum over the global count); the shares add up to it."""
    logits = logits.float()
    n = logits.shape[-1]
    keep = labels >= 0
    if ignore_index is not None:
        keep = keep & (labels != ignore_index)
    safe = torch.where(keep, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe.clamp(max=n - 1)[..., None])[..., 0]
    nll = logz - torch.where(safe < n, picked, 0.0)
    mask = keep.float()
    count = mask.sum()
    if group is not None:
        from maskunet_tpu_torch.parallel.mesh import all_reduce_
        count = all_reduce_(count.detach().clone(), group)
    return (nll * mask).sum() / torch.clamp(count, min=1.0)
