"""Synthetic segmentation dataset: deterministic, generated on the fly.

This package's own copy of maskunet_tpu/data/synthetic.py.

Fills the role of the reference's downloaded subsets for tests and CI
(SURVEY.md §4 integration tests — "ADE-semantic recipe on a synthetic
8-image dataset"): each example paints `num_objects` random axis-aligned
rectangles of random classes over a background, providing consistent
semantic + instance masks without any files on disk. Learnable: each
class has a distinctive mean color.
"""

from __future__ import annotations

import numpy as np


class SyntheticSegmentationDataset:
    def __init__(self, *, num_examples: int = 32, img_size: int = 64,
                 num_classes: int = 8, num_objects: int = 4, seed: int = 0,
                 with_instance: bool = False, ignore_border: bool = False,
                 palette_seed: int = 1234):
        self.num_examples = num_examples
        self.img_size = img_size
        self.num_classes = num_classes
        self.num_objects = num_objects
        self.seed = seed
        self.with_instance = with_instance
        self.ignore_border = ignore_border
        # palette is split-independent: train and val must share the
        # color->class mapping or the task is unlearnable across splits
        rng = np.random.default_rng(palette_seed)
        self.class_colors = rng.integers(
            0, 256, (num_classes, 3)).astype(np.uint8)
        # rectangles are instanced objects; background 0 is stuff
        self.things_labels = set(range(1, num_classes))

    def __len__(self) -> int:
        return self.num_examples

    def image_id(self, idx: int) -> int:
        return idx

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.img_size
        sem = np.zeros((s, s), np.int32)
        inst = np.zeros((s, s), np.int32)
        img = np.zeros((s, s, 3), np.float32)
        img += self.class_colors[0]
        for obj in range(1, self.num_objects + 1):
            cls = int(rng.integers(1, self.num_classes))
            h = int(rng.integers(s // 8, s // 2))
            w = int(rng.integers(s // 8, s // 2))
            y = int(rng.integers(0, s - h))
            x = int(rng.integers(0, s - w))
            sem[y:y + h, x:x + w] = cls
            inst[y:y + h, x:x + w] = obj
            img[y:y + h, x:x + w] = self.class_colors[cls]
        img += rng.normal(0, 8, img.shape)
        out = {
            "image": np.clip(img, 0, 255).astype(np.uint8),
            "label": sem,
        }
        if self.ignore_border:
            out["label"] = out["label"].copy()
            out["label"][:2, :] = 255
        if self.with_instance:
            out["instance"] = inst
        return out
