"""Generate miniature on-disk datasets in the exact reference layouts.

This package's own copy of tools/make_fake_dataset.py: the same functions,
arguments and files, byte for byte, written with cv2 (imported inside the
functions that write). Lets the real (dataset x task) recipes run end to
end without downloads: COCO (panoptic PNGs + panoptic_train_subset.json +
instances jsons, the coco_download.ipynb layout), ADE20K
(images/annotations/objectInfo150.txt), and Cityscapes
(leftImg8bit/gtFine with labelIds/instanceIds).

    python -m maskunet_tpu_torch.tools.make_fake_dataset coco <dir> --n 16

`num_classes` (ADE and COCO) is an argument of `make_ade` and `make_coco`:
ADE at 151 writes the 150 classes and header line of the real
objectInfo150.txt, COCO at 134 writes 133 panoptic categories.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


_NOISE_SIGMA = 6.0      # overridable via --noise: higher = harder task
_MAX_OBJECTS = 4        # overridable via --objects


def _paint_scene(rng, h, w, num_classes, max_objects=None):
    """Random rectangles -> (image, semantic, instance id map)."""
    max_objects = max_objects or _MAX_OBJECTS
    palette = np.random.default_rng(777).integers(
        0, 256, (num_classes, 3)).astype(np.uint8)
    sem = np.zeros((h, w), np.int32)
    inst = np.zeros((h, w), np.int32)
    img = np.full((h, w, 3), palette[0], np.uint8)
    for obj in range(1, int(rng.integers(2, max_objects + 1)) + 1):
        cls = int(rng.integers(1, num_classes))
        hh = int(rng.integers(h // 6, h // 2))
        ww = int(rng.integers(w // 6, w // 2))
        y = int(rng.integers(0, h - hh))
        x = int(rng.integers(0, w - ww))
        sem[y:y + hh, x:x + ww] = cls
        inst[y:y + hh, x:x + ww] = obj
        img[y:y + hh, x:x + ww] = palette[cls]
    noise = rng.normal(0, _NOISE_SIGMA, img.shape)
    img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    return img, sem, inst


def make_coco(root: str, n: int = 16, size: int = 96,
              num_classes: int = 6) -> None:
    import cv2

    from maskunet_tpu_torch.data.coco import id2rgb
    from maskunet_tpu_torch.evaluation import rle as rle_lib

    for d in ("train_subset", "panoptic_train_subset", "val2017",
              "panoptic_val2017", "annotations"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    categories = [{"id": 10 * c + 1, "name": f"cat{c}",
                   "isthing": int(c % 2 == 1)}
                  for c in range(1, num_classes)]
    cat_ids = [c["id"] for c in categories]

    for split, img_dir, pan_dir, pan_json, inst_json, count, seed in [
            ("train", "train_subset", "panoptic_train_subset",
             "panoptic_train_subset.json", "instances_train2017.json", n, 0),
            ("val", "val2017", "panoptic_val2017",
             "panoptic_val2017.json", "instances_val2017.json",
             max(n // 2, 4), 1)]:
        images, pan_anns, inst_anns = [], [], []
        ann_id = 1
        for i in range(count):
            rng = np.random.default_rng(seed * 10000 + i)
            img, sem, inst = _paint_scene(rng, size, size, num_classes)
            img_id = seed * 10000 + i
            fname = f"{img_id:012d}.jpg"
            cv2.imwrite(os.path.join(root, img_dir, fname),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            images.append({"id": img_id, "width": size, "height": size,
                           "file_name": fname})
            # panoptic png: segment id per instance (stuff merged per class)
            seg_map = np.zeros((size, size), np.int64)
            segments = []
            for obj in np.unique(inst):
                if obj == 0:
                    continue
                m = inst == obj
                cls = int(np.bincount(sem[m]).argmax())
                if cls == 0:
                    continue
                seg_id = int(obj) + 1000
                seg_map[m] = seg_id
                segments.append({"id": seg_id,
                                 "category_id": cat_ids[cls - 1],
                                 "iscrowd": 0, "area": int(m.sum()),
                                 "bbox": [0, 0, 1, 1]})
                # instance annotation with RLE segmentation
                inst_anns.append({
                    "id": ann_id, "image_id": img_id,
                    "category_id": cat_ids[cls - 1], "iscrowd": 0,
                    "area": int(m.sum()),
                    "bbox": [0, 0, 1, 1],
                    "segmentation": {
                        "size": [size, size],
                        "counts": rle_lib.encode(
                            m.astype(np.uint8))["counts"]},
                })
                ann_id += 1
            pan_name = f"{img_id:012d}.png"
            cv2.imwrite(os.path.join(root, pan_dir, pan_name),
                        cv2.cvtColor(id2rgb(seg_map), cv2.COLOR_RGB2BGR))
            pan_anns.append({"image_id": img_id, "file_name": pan_name,
                             "segments_info": segments})
        with open(os.path.join(root, "annotations", pan_json), "w") as f:
            json.dump({"images": images, "annotations": pan_anns,
                       "categories": categories}, f)
        with open(os.path.join(root, "annotations", inst_json), "w") as f:
            json.dump({"images": images, "annotations": inst_anns,
                       "categories": categories}, f)


def make_ade(root: str, n: int = 16, size: int = 96,
             num_classes: int = 6) -> None:
    import cv2

    for split in ("training", "validation"):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "annotations", split), exist_ok=True)
    with open(os.path.join(root, "objectInfo150.txt"), "w") as f:
        f.write("Idx Ratio Train Val Name\n")
        for c in range(1, num_classes):
            f.write(f"{c} 0.1 1 1 class{c}\n")
    for split, count, seed in (("training", n, 0),
                               ("validation", max(n // 2, 4), 1)):
        for i in range(count):
            rng = np.random.default_rng(seed * 10000 + i)
            img, sem, _ = _paint_scene(rng, size, size, num_classes)
            cv2.imwrite(os.path.join(root, "images", split, f"{i:06d}.jpg"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(root, "annotations", split,
                                     f"{i:06d}.png"), sem.astype(np.uint8))


def make_cityscapes(root: str, n: int = 16, size: int = 96) -> None:
    import cv2

    # paint the full train-id range so THING classes (train ids 11-18,
    # evaluation/panoptic.py cityscapes_things) actually occur — with
    # ids <8 only, PQ Things evaluates over an empty set
    num_classes = 19
    for split, count, seed in (("train", n, 0), ("val", max(n // 2, 4), 1)):
        img_dir = os.path.join(root, "leftImg8bit", split, "cityx")
        gt_dir = os.path.join(root, "gtFine", split, "cityx")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        for i in range(count):
            rng = np.random.default_rng(seed * 10000 + i)
            img, sem, inst = _paint_scene(rng, size, size, num_classes)
            base = f"cityx_{seed}{i:05d}"
            cv2.imwrite(os.path.join(img_dir, f"{base}_leftImg8bit.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(gt_dir, f"{base}_gtFine_labelIds.png"),
                        sem.astype(np.uint8))
            inst_ids = np.where(inst > 0, sem * 1000 + inst, 0)
            cv2.imwrite(os.path.join(gt_dir,
                                     f"{base}_gtFine_instanceIds.png"),
                        inst_ids.astype(np.uint16))


def main() -> None:
    global _NOISE_SIGMA, _MAX_OBJECTS
    kind, root = sys.argv[1], sys.argv[2]
    n = int(sys.argv[sys.argv.index("--n") + 1]) if "--n" in sys.argv else 16
    if "--noise" in sys.argv:
        _NOISE_SIGMA = float(sys.argv[sys.argv.index("--noise") + 1])
    if "--objects" in sys.argv:
        _MAX_OBJECTS = int(sys.argv[sys.argv.index("--objects") + 1])
    size = (int(sys.argv[sys.argv.index("--size") + 1])
            if "--size" in sys.argv else 96)
    {"coco": make_coco, "ade": make_ade,
     "cityscapes": make_cityscapes}[kind](root, n=n, size=size)
    print(f"wrote fake {kind} dataset to {root}")


if __name__ == "__main__":
    main()
