"""Cityscapes gtFine datasets (semantic / instance / panoptic flavors).

This package's own copy of maskunet_tpu/data/cityscapes.py (decoding
through `data/resize.py`, cv2). Reference label semantics preserved
exactly:

- semantic (city_semantic.py:42-96): images from
  leftImg8bit/<split>/*/*_leftImg8bit.png; labels from the matching
  gtFine `_gtFine_labelIds.png`; ids >= 19 forced to the 255 ignore label
  (city_semantic.py:84) — note the reference treats raw labelIds as train
  ids directly (a quirk kept for parity).
- instance (city_instance.py:45-109): prefers `_gtFine_labelTrainIds.png`,
  falls back to `instanceIds // 1000`; also loads the 16-bit
  `_gtFine_instanceIds.png` (IMREAD_UNCHANGED); semantic ids >= 19 -> 255.
- panoptic (city_panoptic.py:62-126): same pair via wildcard glob.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from maskunet_tpu_torch.data import resize as resize_lib

NUM_CLASSES = 19
IGNORE = 255


class CityscapesDataset:
    def __init__(self, root: str, split: str = "train", img_size: int = 128,
                 with_instance: bool = False):
        self.root = root
        self.split = split
        self.img_size = img_size
        self.with_instance = with_instance
        self.num_classes = NUM_CLASSES
        # Cityscapes train ids 11-18 (person..bicycle) are the classes
        # with instance annotations; 0-10 are stuff
        self.things_labels = set(range(11, NUM_CLASSES))
        pattern = os.path.join(root, "leftImg8bit", split, "*",
                               "*_leftImg8bit.png")
        self.files = sorted(glob.glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no images matching {pattern}")

    def __len__(self) -> int:
        return len(self.files)

    def image_id(self, idx: int) -> int:
        return idx

    def _gt_path(self, img_path: str, suffix: str) -> str:
        rel = os.path.relpath(img_path,
                              os.path.join(self.root, "leftImg8bit"))
        return os.path.join(self.root, "gtFine",
                            rel.replace("_leftImg8bit.png", suffix))

    def _load_semantic(self, img_path: str) -> np.ndarray:
        train_ids = self._gt_path(img_path, "_gtFine_labelTrainIds.png")
        if self.with_instance and os.path.exists(train_ids):
            sem = resize_lib.imread_gray(train_ids)
        elif self.with_instance:
            inst = resize_lib.imread_unchanged(
                self._gt_path(img_path, "_gtFine_instanceIds.png"))
            sem = (inst // 1000).astype(np.int32)
        else:
            sem = resize_lib.imread_gray(
                self._gt_path(img_path, "_gtFine_labelIds.png"))
        sem = sem.astype(np.int32)
        sem[sem >= NUM_CLASSES] = IGNORE
        return sem

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        img_path = self.files[idx]
        img = resize_lib.resize_image(resize_lib.imread_rgb(img_path),
                                      self.img_size)
        sem = resize_lib.resize_mask(self._load_semantic(img_path),
                                     self.img_size)
        out = {"image": img, "label": sem}
        if self.with_instance:
            inst = resize_lib.imread_unchanged(
                self._gt_path(img_path, "_gtFine_instanceIds.png"))
            out["instance"] = resize_lib.resize_mask(
                inst.astype(np.int32), self.img_size)
        return out


class CityscapesPanopticDataset(CityscapesDataset):
    """Wildcard-glob variant (city_panoptic.py:92-110): resolves the gt
    pair by image id anywhere under gtFine/<split>."""

    def __init__(self, root: str, split: str = "train", img_size: int = 128):
        super().__init__(root, split, img_size, with_instance=True)

    def _gt_path(self, img_path: str, suffix: str) -> str:
        base = os.path.basename(img_path).replace("_leftImg8bit.png", "")
        matches = glob.glob(os.path.join(
            self.root, "gtFine", self.split, "*", base + suffix))
        if not matches:
            # fall back to the canonical location; optional files (e.g.
            # labelTrainIds) are probed with os.path.exists upstream, and
            # required ones fail loudly at imread.
            return super()._gt_path(img_path, suffix)
        return matches[0]
