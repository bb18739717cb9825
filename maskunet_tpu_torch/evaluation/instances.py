"""Semantic-map -> instance extraction (host side, numpy + native).

This package's own copy of maskunet_tpu/evaluation/instances.py, which
reimplements the reference's post-processing (ade_instance.py:367-397,
city_panoptic.py:184-209): for every class id != 0 in an argmax semantic
map, connected components become instances; each instance gets a bbox from
its nonzero extent, a score (mean predicted probability of that class over
the component, or 1.0 for ground truth), and an RLE segmentation.
"""

from __future__ import annotations

import numpy as np

from maskunet_tpu_torch.evaluation import rle as rle_lib
from maskunet_tpu_torch.utils import native


def connected_components(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """8-connectivity labeling (cv2.connectedComponents semantics) by the
    native union-find kernel (csrc/maskops.cpp)."""
    return native.cc_label(mask)


def get_instances_from_mask(mask: np.ndarray,
                            prob_map: np.ndarray | None = None,
                            *, min_pixels: int = 1) -> list[dict]:
    """mask: [H, W] int class map; prob_map: [H, W, C] softmax probs or
    None (gt -> score 1.0). Returns COCO-style instance dicts."""
    instances = []
    for cls in np.unique(mask):
        if cls == 0:
            continue
        num, comps = connected_components(mask == cls)
        for comp in range(1, num):
            m = comps == comp
            npix = int(np.count_nonzero(m))
            if npix < min_pixels:
                continue
            ys, xs = np.nonzero(m)
            x0, x1 = int(xs.min()), int(xs.max())
            y0, y1 = int(ys.min()), int(ys.max())
            score = (float(prob_map[..., int(cls)][m].mean())
                     if prob_map is not None else 1.0)
            instances.append({
                "category_id": int(cls),
                "bbox": [x0, y0, x1 - x0 + 1, y1 - y0 + 1],
                "score": score,
                "area": npix,
                "segmentation": rle_lib.encode(m.astype(np.uint8)),
            })
    return instances


def top_k_by_score(instances: list[dict], k: int) -> list[dict]:
    """The reference's max_queries cap (ade_instance.py:417-421)."""
    return sorted(instances, key=lambda d: -d["score"])[:k]


def instances_from_id_map(inst_map: np.ndarray, sem_map: np.ndarray,
                          *, ignore: int = 0) -> list[dict]:
    """Ground-truth instances from an instance-id map + semantic map
    (city_instance.py gt path): one instance per id, category = majority
    semantic label inside it."""
    instances = []
    for iid in np.unique(inst_map):
        if iid == ignore:
            continue
        m = inst_map == iid
        labels, counts = np.unique(sem_map[m], return_counts=True)
        cat = int(labels[np.argmax(counts)])
        if cat == 0 or cat == 255:
            continue
        ys, xs = np.nonzero(m)
        instances.append({
            "category_id": cat,
            "bbox": [int(xs.min()), int(ys.min()),
                     int(xs.max() - xs.min() + 1),
                     int(ys.max() - ys.min() + 1)],
            "score": 1.0,
            "area": int(m.sum()),
            "segmentation": rle_lib.encode(m.astype(np.uint8)),
        })
    return instances
