"""Dataset construction per (recipe.dataset, recipe.task).

Counterpart of maskunet_tpu/tasks/datasets.py. The seeded synthetic
dataset (the JAX package's data-free stand-in) is built exactly as there;
the ADE20K, COCO and Cityscapes readers decode PNG and JPEG with cv2,
which the card's machine lacks, and come with the data slice.
"""

from __future__ import annotations

from maskunet_tpu_torch.data import synthetic
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

    if ds in ("ade20k", "coco", "cityscapes"):
        raise NotImplementedError(
            f"dataset {ds!r}: data slice (its readers decode PNG and JPEG "
            "with cv2, which the port does not have yet)")
    raise ValueError(f"unknown dataset {ds!r}")
