"""Segmentation metrics on the device, no host syncs.

Counterpart of maskunet_tpu/ops/metrics_ops.py. `mean_iou` follows the
reference metric (ade_semantic.py:128-146): argmax of the logits (the
temperature-0.5 softmax does not change it), per-class intersection and
union over the whole batch, classes with union 0 skipped, smoothing 1e-6.
Histograms are `scatter_add_` into a bin past the last class for the
pixels that are dropped, so nothing waits on the card.
"""

from __future__ import annotations

import torch


def predictions(logits: torch.Tensor, temperature: float = 0.5
                ) -> torch.Tensor:
    """argmax class map from NHWC logits (ties: the first class)."""
    del temperature
    return logits.argmax(dim=-1)


def probabilities(logits: torch.Tensor, temperature: float = 0.5
                  ) -> torch.Tensor:
    """softmax(logits / T) in f32."""
    return torch.softmax(logits.float() / temperature, dim=-1)


def _histogram(values: torch.Tensor, weight: torch.Tensor,
               n: int) -> torch.Tensor:
    """Counts of `values` in [0, n) where `weight`; others are dropped."""
    ok = weight & (values >= 0) & (values < n)
    idx = torch.where(ok, values, n).long()   # int32 labels too
    counts = torch.zeros(n + 1, dtype=torch.int64, device=values.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx))[:n]


def iou_counts(pred: torch.Tensor, labels: torch.Tensor, num_classes: int,
               ignore_index: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class (intersection, union) int32 counts over all given pixels;
    negative labels are always out, labels >= num_classes count nowhere."""
    pred = pred.reshape(-1)
    labels = labels.reshape(-1)
    keep = labels >= 0
    if ignore_index is not None:
        keep = keep & (labels != ignore_index)
    inter = _histogram(pred, keep & (pred == labels), num_classes)
    union = (_histogram(pred, keep, num_classes)
             + _histogram(labels, keep, num_classes) - inter)
    return inter.to(torch.int32), union.to(torch.int32)


def mean_iou(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
             smooth: float = 1e-6,
             ignore_index: int | None = None, group=None) -> torch.Tensor:
    """Batch mIoU, reference semantics (ignore pixels stay in the union
    unless `ignore_index` is given). `group` (the data axis): the
    histograms are all-reduced, so it is the global batch's mIoU."""
    inter, union = iou_counts(predictions(logits), labels, num_classes,
                              ignore_index)
    if group is not None:
        from maskunet_tpu_torch.parallel.mesh import all_reduce_
        counts = all_reduce_(torch.stack([inter, union]), group)
        inter, union = counts[0], counts[1]
    present = union > 0
    iou = (inter.float() + smooth) / (union.float() + smooth)
    return (torch.where(present, iou, 0.0).sum()
            / torch.clamp(present.float().sum(), min=1.0))


def confusion_matrix(pred: torch.Tensor, labels: torch.Tensor,
                     num_classes: int,
                     ignore_index: int | None = None) -> torch.Tensor:
    """[C, C] int32 confusion counts (rows = true, cols = pred). As
    `jnp.bincount` does, a negative flat index counts in bin 0 and one past
    the end is dropped."""
    pred = pred.reshape(-1)
    labels = labels.reshape(-1)
    w = torch.ones_like(pred, dtype=torch.bool)
    if ignore_index is not None:
        w = labels != ignore_index
        pred = torch.where(w, pred, 0)
        labels = torch.where(w, labels, 0)
    n = num_classes * num_classes
    flat = torch.clamp(labels * num_classes + pred, min=0)
    return _histogram(flat, w, n).to(torch.int32).reshape(num_classes,
                                                          num_classes)
