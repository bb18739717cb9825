"""Deterministic dataset subsetting for data-efficiency sweeps.

This package's own copy of maskunet_tpu/data/subset.py.

The reference's headline data-fraction experiment trains on 10/25/50/75/
100% of panoptic_train2017 (BASELINE.md; figures/Segmentation_performance
.png). `FractionSubset` picks a seeded random subset so sweeps are
reproducible and nested (the 10% subset is contained in the 25% one,
matching how such sweeps are usually run)."""

from __future__ import annotations

import numpy as np


class FractionSubset:
    def __init__(self, dataset, fraction: float, seed: int = 0):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.dataset = dataset
        order = np.random.default_rng(seed).permutation(len(dataset))
        n = max(1, int(round(len(dataset) * fraction)))
        self.indices = np.sort(order[:n])

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[int(self.indices[idx])]

    def image_id(self, idx: int) -> int:
        base = int(self.indices[idx])
        fn = getattr(self.dataset, "image_id", None)
        return int(fn(base)) if fn is not None else base

    def __getattr__(self, name):
        # delegate metadata (num_classes, cat2label, ...) to the base
        return getattr(self.dataset, name)
