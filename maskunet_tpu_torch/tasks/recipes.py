"""The training recipes, as a table.

This package's own copy of maskunet_tpu/tasks/recipes.py (which cannot be
imported: it pulls in the JAX train step for `TaskConfig`). The table must
stay equal to the JAX one field for field; a test holds it there.
`TaskConfig`, the loss blend, lives in `train/step.py`, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

from maskunet_tpu_torch.train.step import TaskConfig


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    dataset: str                 # 'ade20k' | 'coco' | 'cityscapes' | 'synthetic'
    task: str                    # 'semantic' | 'instance' | 'panoptic'
    batch_size: int
    lr: float
    weight_decay: float
    task_config: TaskConfig
    num_classes: int | None = None   # None: derived from the dataset
    embed_dim: int = 0
    with_boundary_head: bool = False
    img_size: int = 128
    num_epochs: int = 1000
    patience: int = 10
    overfit_margin: float = 0.1
    checkpoint_name: str = "checkpoint"
    seed: int = 42
    eval_max_queries: tuple[int, ...] = (50, 100, 150, 200)
    attn_output_layout: str = "transpose"


_R = Recipe
RECIPES: dict[str, Recipe] = {r.name: r for r in [
    _R("ade_semantic", "ade20k", "semantic", 8, 5e-5, 1e-1,
       TaskConfig(), checkpoint_name="checkpoint_ade"),
    _R("ade_instance", "ade20k", "instance", 8, 1e-2, 1e-1,
       TaskConfig(), checkpoint_name="checkpoint_ade_inst"),
    _R("ade_panoptic", "ade20k", "panoptic", 8, 5e-5, 1e-3,
       TaskConfig(ce_weight=0.9, triplet_weight=0.1),
       checkpoint_name="checkpoint_ade_pan"),
    _R("city_semantic", "cityscapes", "semantic", 1, 1e-4, 1e-4,
       TaskConfig(ignore_index=255), num_classes=19,
       checkpoint_name="checkpoint_cityscapes"),
    _R("city_instance", "cityscapes", "instance", 8, 1e-3, 1e-1,
       TaskConfig(ignore_index=255, triplet_weight=0.5,
                  triplet_features="embeddings", triplet_ignore_label=255),
       num_classes=19, embed_dim=16, with_boundary_head=True,
       checkpoint_name="checkpoint_cityscapes_inst",
       eval_max_queries=(30, 50, 70, 100)),
    _R("city_panoptic", "cityscapes", "panoptic", 1, 1e-2, 1e-4,
       TaskConfig(ce_weight=0.9, triplet_weight=0.1, ignore_index=255),
       num_classes=19, checkpoint_name="checkpoint_city_pan"),
    _R("coco_semantic", "coco", "semantic", 8, 1e-5, 1e-4,
       TaskConfig(), checkpoint_name="checkpoint"),
    _R("coco_instance", "coco", "instance", 4, 1e-5, 1e-4,
       TaskConfig(), checkpoint_name="checkpoint_instance"),
    _R("coco_panoptic", "coco", "panoptic", 14, 1e-5, 1e-4,
       TaskConfig(ce_weight=0.9, triplet_weight=0.1),
       checkpoint_name="checkpoint_pan"),
    _R("synthetic_semantic", "synthetic", "semantic", 8, 1e-3, 1e-4,
       TaskConfig(), num_classes=8, img_size=64,
       checkpoint_name="checkpoint_synth"),
    _R("synthetic_panoptic", "synthetic", "panoptic", 8, 1e-3, 1e-4,
       TaskConfig(ce_weight=0.9, triplet_weight=0.1), num_classes=8,
       img_size=64, checkpoint_name="checkpoint_synth_pan"),
]}


def get(name: str) -> Recipe:
    if name not in RECIPES:
        raise KeyError(
            f"unknown recipe {name!r}; available: {sorted(RECIPES)}")
    return RECIPES[name]
