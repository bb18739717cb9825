"""Embedding-space instance decoding (DBSCAN), cityscapes-instance path.

Counterpart of maskunet_tpu/evaluation/clustering.py, which reimplements
`get_instances_from_embeddings` (city_instance.py:405-429): for each
predicted semantic class, cluster that class's pixels in the 16-d
embedding space with DBSCAN(eps=0.5, min_samples=5); each cluster becomes
an instance mask. `annotate_instances` (city_instance.py:431-449) then
builds COCO-style records: bbox from extent, category = median class
inside the mask, score 1.0, RLE segmentation.

The JAX package clusters with scikit-learn on the host; the card's machine
has no scikit-learn, so `dbscan` is the port's own, in PyTorch on the
device of the embeddings (the card when the eval step ran there). It gives
scikit-learn's labels:

- squared distances in f64 by scikit-learn's formula for its brute-force
  radius search, |x|^2 + (-2 x.y) + |y|^2 clamped at 0, compared with
  eps^2 (so the two differ only where a pair's distance lies within f64
  rounding of eps);
- a point is a core point when it has at least `min_samples` neighbours
  within eps, itself counted;
- clusters are the connected components of the core graph, numbered in
  the order of their lowest-index core point;
- a border point takes the lowest-numbered cluster among its core
  neighbours; every other point is noise (-1).

Distances are computed a tile of rows at a time and never stored whole
(16,384 pixels of one class would make a 2 GB f64 matrix): one pass counts
the neighbours, then passes of min-label propagation over the core graph,
each followed by pointer jumping, run until the labels stop changing; the
last pass also gives the border points their clusters.
"""

from __future__ import annotations

import numpy as np
import torch

from maskunet_tpu_torch.evaluation import rle as rle_lib

_TILE_ENTRIES = 1 << 24   # distances a tile holds: 128 MB in f64


def dbscan(x: torch.Tensor, *, eps: float = 0.5, min_samples: int = 5
           ) -> torch.Tensor:
    """x [N, D] -> int64 labels [N] on x's device: scikit-learn's
    `DBSCAN(eps, min_samples).fit_predict` (euclidean)."""
    x = x.double()
    n = x.shape[0]
    dev = x.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    sq = (x * x).sum(1)
    tile = max(1, _TILE_ENTRIES // n)
    starts = range(0, n, tile)
    radius2 = eps * eps

    def within(start: int) -> torch.Tensor:
        rows = slice(start, start + tile)
        d2 = (sq[rows, None] + -2.0 * (x[rows] @ x.T)) + sq[None, :]
        return d2.clamp_(min=0.0) <= radius2

    core = torch.cat([within(s).sum(1) for s in starts]) >= min_samples
    none = n                                  # "no core neighbour"
    label = torch.where(core, torch.arange(n, device=dev), none)
    while True:
        # each point's least label among its core neighbours (non-core
        # points carry `none`, so they never pass a label on)
        least = torch.cat([torch.where(within(s), label[None, :], none)
                           .amin(1) for s in starts])
        new = torch.where(core, least, none)
        while True:   # a core's label is a core index of its component
            jumped = torch.where(core, new[new.clamp(max=n - 1)], none)
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            break
        label = new
    # converged: `least` is each core's component root (its lowest core
    # index) and each border point's least root among its core neighbours
    found = least < none
    roots = torch.unique(least[found])        # sorted: clusters in order
    return torch.where(found, torch.searchsorted(roots, least), -1)


def instances_from_embeddings(sem_pred: np.ndarray, embeddings, *,
                              eps: float = 0.5, min_samples: int = 5,
                              ignore: int = 255,
                              max_pixels_per_class: int | None = None
                              ) -> list[np.ndarray]:
    """sem_pred: [H, W] argmax classes (numpy); embeddings: [H, W, D] (a
    tensor on any device, or numpy: the CPU). Returns a list of boolean
    instance masks, class by class in ascending order, clusters in
    order."""
    emb = torch.as_tensor(embeddings)
    h, w = sem_pred.shape
    flat_emb = emb.reshape(h * w, -1)
    masks: list[np.ndarray] = []
    for cls in np.unique(sem_pred):
        if cls == 0 or cls == ignore:
            continue
        ys, xs = np.nonzero(sem_pred == cls)
        if len(ys) < min_samples:
            continue
        if max_pixels_per_class is not None and len(ys) > max_pixels_per_class:
            sel = np.random.default_rng(0).choice(
                len(ys), max_pixels_per_class, replace=False)
            ys, xs = ys[sel], xs[sel]
        rows = torch.from_numpy(ys * w + xs).to(flat_emb.device)
        labels = dbscan(flat_emb[rows], eps=eps,
                        min_samples=min_samples).cpu().numpy()
        for lab in np.unique(labels):
            if lab == -1:   # noise
                continue
            m = np.zeros((h, w), bool)
            pick = labels == lab
            m[ys[pick], xs[pick]] = True
            masks.append(m)
    return masks


def annotate_instances(masks: list[np.ndarray],
                       sem_pred: np.ndarray) -> list[dict]:
    """COCO-style records from instance masks (city_instance.py:431-449:
    category = median semantic class inside the mask, score 1.0)."""
    out = []
    for m in masks:
        if not m.any():
            continue
        ys, xs = np.nonzero(m)
        cat = int(np.median(sem_pred[m]))
        if cat == 0 or cat == 255:
            continue
        out.append({
            "category_id": cat,
            "bbox": [int(xs.min()), int(ys.min()),
                     int(xs.max() - xs.min() + 1),
                     int(ys.max() - ys.min() + 1)],
            "score": 1.0,
            "area": int(m.sum()),
            "segmentation": rle_lib.encode(m.astype(np.uint8)),
        })
    return out
