"""Dataset construction per (recipe.dataset, recipe.task).

Counterpart of maskunet_tpu/tasks/datasets.py. Maps each of the nine
recipes to its readers with the reference's directory conventions
(SURVEY.md §2.2): ADE20K root with images/annotations +
objectInfo150.txt; COCO root with the coco_download.ipynb layout
(train_subset/, panoptic_train_subset(.json), val2017/,
panoptic_val2017(.json), annotations/instances_*.json); Cityscapes root
with leftImg8bit/ + gtFine/. The seeded synthetic dataset needs no files.
"""

from __future__ import annotations

import os

from maskunet_tpu_torch.data import ade20k, cityscapes, coco, synthetic
from maskunet_tpu_torch.tasks.recipes import Recipe


def make_datasets(recipe: Recipe, data_root: str | None):
    """Returns (train_ds, val_ds, num_classes)."""
    ds, task, size = recipe.dataset, recipe.task, recipe.img_size

    if ds == "synthetic":
        kwargs = dict(img_size=size, num_classes=recipe.num_classes or 8,
                      with_instance=task != "semantic")
        train = synthetic.SyntheticSegmentationDataset(
            num_examples=64, seed=recipe.seed, **kwargs)
        val = synthetic.SyntheticSegmentationDataset(
            num_examples=16, seed=recipe.seed + 1, **kwargs)
        return train, val, recipe.num_classes or 8

    if ds in ("ade20k", "cityscapes", "coco") and data_root is None:
        raise ValueError(f"dataset {ds!r} reads its files under data_root, "
                         "which is None")

    if ds == "ade20k":
        cls = (ade20k.ADE20KPanopticDataset if task == "panoptic"
               else ade20k.ADE20KSemanticDataset)
        train = cls(data_root, "training", img_size=size)
        val = cls(data_root, "validation", img_size=size)
        return train, val, train.num_classes

    if ds == "cityscapes":
        if task == "panoptic":
            train = cityscapes.CityscapesPanopticDataset(
                data_root, "train", img_size=size)
            val = cityscapes.CityscapesPanopticDataset(
                data_root, "val", img_size=size)
        else:
            with_inst = task == "instance"
            train = cityscapes.CityscapesDataset(
                data_root, "train", img_size=size, with_instance=with_inst)
            val = cityscapes.CityscapesDataset(
                data_root, "val", img_size=size, with_instance=with_inst)
        return train, val, train.num_classes

    if ds == "coco":
        ann = os.path.join(data_root, "annotations")
        if task == "instance":
            train = coco.COCOInstanceDataset(
                os.path.join(ann, "instances_train2017.json"),
                os.path.join(data_root, "train_subset"), img_size=size)
            val = coco.COCOInstanceDataset(
                os.path.join(ann, "instances_val2017.json"),
                os.path.join(data_root, "val2017"), img_size=size)
            return train, val, train.num_classes
        cls = (coco.COCOPanopticDataset if task == "panoptic"
               else coco.COCOSemanticDataset)
        train = cls(os.path.join(ann, "panoptic_train_subset.json"),
                    os.path.join(data_root, "panoptic_train_subset"),
                    os.path.join(data_root, "train_subset"), img_size=size)
        val = cls(os.path.join(ann, "panoptic_val2017.json"),
                  os.path.join(data_root, "panoptic_val2017"),
                  os.path.join(data_root, "val2017"), img_size=size)
        return train, val, train.num_classes

    raise ValueError(f"unknown dataset {ds!r}")
