"""Instance-contrastive triplet loss over pixel features.

Counterpart of maskunet_tpu/losses/triplet.py: the reference's
`InstanceContrastiveLoss`, a TripletMarginLoss(margin=1.0, p=2) over pixel
feature vectors, in the vectorised form the JAX package gives it (its
documented intent, not the reference's per-instance host loop):

- `num_samples` anchor pixels per image among pixels whose instance id is
  not background (0) and not `ignore_label`;
- a positive: a random other pixel of the anchor's instance;
- a negative: a random pixel outside it (background allowed, never
  `ignore_label`);
- per triplet max(0, d(a,p) - d(a,n) + margin) with torch's
  pairwise_distance eps (d = ||a - b + 1e-6||_2), averaged over the usable
  triplets.

Sampling keeps the JAX rules: uniform scores plus 2.0 on the eligible
entries, then top-k (anchors) or argmax (positives, negatives). The draws
come from an explicit `torch.Generator`, so they differ from JAX's keys;
`triplet_from_indices` takes the indices, so both packages can be handed
the same triplets.
"""

from __future__ import annotations

import torch

_BIG = 2.0  # added to uniform(0,1) scores to make eligible entries dominate


def _torch_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.nn.functional.pairwise_distance semantics (eps=1e-6)."""
    return torch.sqrt(torch.sum(torch.square(a - b + 1e-6), dim=-1))


def sample_triplets(generator: torch.Generator, instance_mask: torch.Tensor,
                    *, num_samples: int = 32, ignore_label: int | None = None
                    ) -> tuple[torch.Tensor, ...]:
    """Draw (anchor, positive, negative) pixel indices per image.

    instance_mask: [B,H,W] int, on the generator's device. Returns (a_idx,
    p_idx, n_idx, weight), each [B, K] with flat-HW indices (int64);
    weight (f32) is 1.0 where the triplet is usable. Three draws from
    `generator`, in this order: anchor scores [B, HW], positive and
    negative scores [B, K, HW]."""
    b = instance_mask.shape[0]
    hw = instance_mask.shape[1] * instance_mask.shape[2]
    ids = instance_mask.reshape(b, hw)
    dev = ids.device

    valid = ids != 0
    if ignore_label is not None:
        valid &= ids != ignore_label

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    a_scores = uniform(b, hw) + valid * _BIG
    a_idx = torch.topk(a_scores, num_samples, dim=1).indices      # [B, K]
    a_ids = torch.gather(ids, 1, a_idx)
    a_valid = torch.gather(valid, 1, a_idx)

    same = ids[:, None, :] == a_ids[:, :, None]                   # [B, K, HW]
    is_self = torch.arange(hw, device=dev)[None, None, :] == a_idx[:, :, None]

    pos_elig = same & ~is_self
    p_idx = (uniform(b, num_samples, hw) + pos_elig * _BIG).argmax(-1)
    p_ok = torch.gather(pos_elig, 2, p_idx[..., None])[..., 0]

    neg_elig = ~same                                 # any pixel outside
    if ignore_label is not None:
        neg_elig &= ids[:, None, :] != ignore_label
    n_idx = (uniform(b, num_samples, hw) + neg_elig * _BIG).argmax(-1)
    n_ok = torch.gather(neg_elig, 2, n_idx[..., None])[..., 0]

    weight = (a_valid & p_ok & n_ok).float()
    return a_idx, p_idx, n_idx, weight


def triplet_from_indices(features: torch.Tensor, a_idx: torch.Tensor,
                         p_idx: torch.Tensor, n_idx: torch.Tensor,
                         weight: torch.Tensor, *,
                         margin: float = 1.0, group=None) -> torch.Tensor:
    """TripletMarginLoss over pre-sampled flat pixel indices, in f32.
    features: [B,H,W,C]. `group` (the data axis): the weight sum counts
    every rank's triplets, so the result is this rank's share of the
    global mean (see `cross_entropy`)."""
    b, h, w, c = features.shape
    feats = features.reshape(b, h * w, c).float()

    def gather(idx):
        return torch.gather(feats, 1, idx[..., None].expand(-1, -1, c))

    a_f, p_f, n_f = gather(a_idx), gather(p_idx), gather(n_idx)
    per_triplet = torch.relu(_torch_distance(a_f, p_f)
                             - _torch_distance(a_f, n_f) + margin)
    total = weight.sum()
    if group is not None:
        from maskunet_tpu_torch.parallel.mesh import all_reduce_
        total = all_reduce_(total.detach().clone(), group)
    return (per_triplet * weight).sum() / torch.clamp(total, min=1.0)

