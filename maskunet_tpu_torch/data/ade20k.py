"""ADE20K datasets (semantic / instance-synthesis / panoptic flavors).

This package's own copy of maskunet_tpu/data/ade20k.py (decoding through
`data/resize.py`, connected components through cv2). Reproduces the
reference's loaders byte-for-byte in label semantics:

- `ADE20KSemanticDataset` (ade_semantic.py:34-79): lists
  images/{training,validation} jpg/png; annotation = same basename .png,
  grayscale pixel value == class id; image resized INTER_LINEAR, mask
  INTER_NEAREST to img_size; identity cat2label. The category count comes
  from counting non-empty lines of objectInfo150.txt — which includes the
  header line (ade_semantic.py:42-48), so c_out is 151 for the standard
  file. Faithfully kept (it only adds one never-predicted class).
- `ADE20KPanopticDataset` (ade_panoptic.py:36-100): additionally
  synthesizes an instance mask from the semantic mask via per-class
  connected components.
"""

from __future__ import annotations

import os

import numpy as np

from maskunet_tpu_torch.data import resize as resize_lib


def load_categories(objectinfo_txt: str) -> list[str]:
    with open(objectinfo_txt) as f:
        return [line.strip() for line in f if line.strip()]


class ADE20KSemanticDataset:
    def __init__(self, root: str, split: str = "training",
                 img_size: int = 128):
        self.root = root
        self.img_dir = os.path.join(root, "images", split)
        self.ann_dir = os.path.join(root, "annotations", split)
        self.img_size = img_size
        self.categories = load_categories(
            os.path.join(root, "objectInfo150.txt"))
        self.cat2label = {i: i for i in range(len(self.categories))}
        self.num_classes = len(self.categories)
        # every non-background class is a "thing": ADE panoptic here
        # synthesizes instances per class via connected components
        # (generate_instance_mask, ade_panoptic.py:36-47), so all classes
        # participate in instance matching
        self.things_labels = set(range(1, self.num_classes))
        self.files = sorted(
            f for f in os.listdir(self.img_dir)
            if f.endswith((".jpg", ".png")))

    def image_id(self, idx: int) -> int:
        return idx

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        name = self.files[idx]
        img = resize_lib.imread_rgb(os.path.join(self.img_dir, name))
        ann_name = os.path.splitext(name)[0] + ".png"
        mask = resize_lib.imread_gray(os.path.join(self.ann_dir, ann_name))
        img = resize_lib.resize_image(img, self.img_size)
        mask = resize_lib.resize_mask(mask, self.img_size)
        return img, mask.astype(np.int32)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        img, mask = self._load(idx)
        return {"image": img, "label": mask}


def instance_mask_from_semantic(semantic: np.ndarray) -> np.ndarray:
    """Per-class connected components -> globally unique instance ids
    (generate_instance_mask, ade_panoptic.py:36-47)."""
    import cv2

    inst = np.zeros_like(semantic, dtype=np.int32)
    next_id = 1
    for cls in np.unique(semantic):
        if cls == 0:
            continue
        num, comps = cv2.connectedComponents(
            (semantic == cls).astype(np.uint8))
        for comp in range(1, num):
            inst[comps == comp] = next_id
            next_id += 1
    return inst


class ADE20KPanopticDataset(ADE20KSemanticDataset):
    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        img, mask = self._load(idx)
        return {"image": img, "label": mask,
                "instance": instance_mask_from_semantic(mask)}
