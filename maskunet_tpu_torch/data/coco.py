"""COCO datasets: panoptic-PNG-driven semantic/panoptic, and instance.

This package's own copy of maskunet_tpu/data/coco.py (decoding through
`data/resize.py`, cv2). Reference semantics preserved:

- `rgb2id`: panoptic PNG color -> segment id (R + 256*G + 256^2*B) — the
  panopticapi util the reference imports (coco_semantic.py:70).
- cat2label = rank of the category id in the sorted id list (133 panoptic
  classes -> labels 0..132, coco_semantic.py:44-45).
- semantic mask painted per segment; panoptic flavor also paints
  instance_mask = segment id (coco_panoptic.py:51-97). Background (no
  segment) stays label 0 — the reference quirk where label 0 doubles as
  "first category" and "unlabeled".
- instance flavor (coco_instance.py:36-88): all annotation masks per image
  (polygons rasterized, crowd RLE decoded), resized nearest. The reference
  training target collapses them with `sum(masks)` so overlap counts become
  class indices (coco_instance.py:331-341); `summed_target=True` reproduces
  that dataset-side, clipped into the valid class range to keep CE finite.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from maskunet_tpu_torch.data import resize as resize_lib
from maskunet_tpu_torch.evaluation import rle as rle_lib


def rgb2id(color: np.ndarray) -> np.ndarray:
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    out = np.zeros(id_map.shape + (3,), dtype=np.uint8)
    out[..., 0] = id_map % 256
    out[..., 1] = (id_map // 256) % 256
    out[..., 2] = (id_map // (256 * 256)) % 256
    return out


class COCOPanopticDataset:
    """Panoptic-JSON-driven dataset; `with_instance=False` gives the
    semantic flavor (coco_semantic.py), True the panoptic one."""

    def __init__(self, panoptic_json: str, panoptic_root: str, img_dir: str,
                 img_size: int = 128, with_instance: bool = True):
        self.img_dir = img_dir
        self.panoptic_root = panoptic_root
        self.img_size = img_size
        self.with_instance = with_instance
        with open(panoptic_json) as f:
            data = json.load(f)
        self.images = data["images"]
        self.annotations = {a["image_id"]: a for a in data["annotations"]}
        self.categories = data["categories"]
        all_ids = sorted(c["id"] for c in self.categories)
        self.cat2label = {cid: i for i, cid in enumerate(all_ids)}
        self.label2cat = {i: cid for cid, i in self.cat2label.items()}
        self.num_classes = len(all_ids)
        self.things_labels = {self.cat2label[c["id"]]
                              for c in self.categories if c.get("isthing", 1)}

    def __len__(self) -> int:
        return len(self.images)

    def image_id(self, idx: int) -> int:
        """Real COCO image id (the reference keys its eval/export JSONs
        by these, coco_panoptic.py:388-425)."""
        return int(self.images[idx]["id"])

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        info = self.images[idx]
        h, w = info["height"], info["width"]
        img = resize_lib.imread_rgb(
            os.path.join(self.img_dir, info["file_name"]))
        ann = self.annotations[info["id"]]
        seg_rgb = resize_lib.imread_rgb(
            os.path.join(self.panoptic_root, ann["file_name"]))
        seg_id_map = rgb2id(seg_rgb)

        semantic = np.zeros((h, w), np.int32)
        instance = np.zeros((h, w), np.int32)
        for seg in ann["segments_info"]:
            pixels = seg_id_map == seg["id"]
            semantic[pixels] = self.cat2label[seg["category_id"]]
            instance[pixels] = seg["id"]

        img = resize_lib.resize_image(img, self.img_size)
        semantic = resize_lib.resize_mask(semantic, self.img_size)
        out = {"image": img, "label": semantic}
        if self.with_instance:
            out["instance"] = resize_lib.resize_mask(instance, self.img_size)
        return out


class COCOSemanticDataset(COCOPanopticDataset):
    def __init__(self, *args, **kwargs):
        kwargs["with_instance"] = False
        super().__init__(*args, **kwargs)


class COCOInstanceDataset:
    """instances_*.json-driven dataset (coco_instance.py:36-88).

    `summed_target=True` (training) returns the reference's summed-mask
    integer map as "label"; False returns the ragged per-instance stack
    under "masks"/"labels" for host-side evaluation.
    """

    def __init__(self, instances_json: str, img_dir: str,
                 img_size: int = 128, summed_target: bool = True):
        self.img_dir = img_dir
        self.img_size = img_size
        self.summed_target = summed_target
        with open(instances_json) as f:
            data = json.load(f)
        self.images = data["images"]
        self.anns_by_image: dict[int, list] = defaultdict(list)
        for ann in data["annotations"]:
            self.anns_by_image[ann["image_id"]].append(ann)
        self.categories = {c["id"]: c for c in data["categories"]}
        # reference: c_out = len(coco.cats) + 1 (coco_instance.py:289)
        self.num_classes = len(self.categories) + 1
        # this dataset's label space is summed-mask overlap COUNTS
        # (0..num_classes-1), not category ids; treat every nonzero
        # count as a "thing" for the (degenerate) panoptic view
        self.things_labels = set(range(1, self.num_classes))

    def __len__(self) -> int:
        return len(self.images)

    def image_id(self, idx: int) -> int:
        return int(self.images[idx]["id"])

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        info = self.images[idx]
        h, w = info["height"], info["width"]
        img = resize_lib.imread_rgb(
            os.path.join(self.img_dir, info["file_name"]))
        img = resize_lib.resize_image(img, self.img_size)

        masks, labels = [], []
        for ann in self.anns_by_image.get(info["id"], []):
            m = rle_lib.segmentation_to_mask(ann["segmentation"], h, w)
            masks.append(resize_lib.resize_mask(m, self.img_size))
            labels.append(ann["category_id"])

        if self.summed_target:
            if masks:
                summed = np.sum(np.stack(masks).astype(np.int64), axis=0)
                # overlaps count upward (reference quirk); clip to CE range
                summed = np.clip(summed, 0, self.num_classes - 1)
            else:
                summed = np.zeros((self.img_size, self.img_size), np.int64)
            return {"image": img, "label": summed.astype(np.int32)}

        return {
            "image": img,
            "masks": (np.stack(masks) if masks else
                      np.zeros((0, self.img_size, self.img_size), np.uint8)),
            "labels": np.asarray(labels, np.int32),
            "image_id": np.asarray(info["id"], np.int64),
        }
