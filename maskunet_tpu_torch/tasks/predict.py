"""Batch inference: run a trained state over a directory of images.

Counterpart of maskunet_tpu/tasks/predict.py, on `device` (the card
unless the caller asks for the CPU). Streams images through the host
pipeline in fixed-size batches (padding the tail), runs the eval step, and
writes one class-id PNG per input, and optionally its instance-id PNG, the
panopticapi export and a colour panel, with a `predictions.json` manifest.
Images are read and PNGs written with cv2 (`data/resize.py`); panels need
matplotlib (`utils/visualize.py`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from maskunet_tpu_torch.core.device import resolve_device
from maskunet_tpu_torch.data import pipeline, resize as resize_lib
from maskunet_tpu_torch.models import maskattn_unet as model_lib
from maskunet_tpu_torch.tasks.recipes import Recipe
from maskunet_tpu_torch.train import loop as loop_lib
from maskunet_tpu_torch.train import step as step_lib

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class _DirectoryDataset:
    def __init__(self, directory: str, img_size: int):
        self.files = sorted(
            f for f in os.listdir(directory)
            if f.lower().endswith(_IMG_EXTS))
        if not self.files:
            raise FileNotFoundError(f"no images in {directory}")
        self.directory = directory
        self.img_size = img_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        img = resize_lib.imread_rgb(
            os.path.join(self.directory, self.files[idx]))
        return {"image": resize_lib.resize_image(img, self.img_size),
                "label": np.zeros((self.img_size, self.img_size), np.int32)}


def _decode_instances(pred, prob, embeddings):
    """Instance masks for one image: DBSCAN over the 16-d embeddings when
    the model has the embedding head (city_instance.py:405-429 pathway;
    the DBSCAN runs where the embeddings are), per-class connected
    components otherwise (ade_instance.py:367-397). Returns (instance-id
    map uint16, COCO-style records)."""
    from maskunet_tpu_torch.evaluation import clustering, instances
    from maskunet_tpu_torch.evaluation import rle as rle_lib

    if embeddings is not None:
        masks = clustering.instances_from_embeddings(pred, embeddings)
        records = clustering.annotate_instances(masks, pred)
    else:
        records = instances.get_instances_from_mask(pred, prob)
    # id map ids == 1-based positions in `records` (annotate_instances
    # may filter masks, so rebuild from the records' RLEs)
    id_map = np.zeros(pred.shape, np.uint16)
    for k, r in enumerate(records, 1):
        id_map[rle_lib.decode(r["segmentation"]).astype(bool)] = k
    return id_map, records


def predict_directory(recipe: Recipe, ts, images_dir: str, out_dir: str, *,
                      num_classes: int, attn_impl: str = "auto",
                      compute_dtype: str = "float32",
                      save_panels: bool = False,
                      save_instances: bool = False,
                      save_panoptic: bool = False,
                      device: str | torch.device = "cuda") -> list[str]:
    """Returns the list of written mask paths."""
    import cv2

    if save_panoptic:
        from maskunet_tpu_torch.evaluation import panoptic
    if save_panels:
        from maskunet_tpu_torch.utils import visualize

    dev = resolve_device(device)
    cfg = loop_lib.model_config(recipe, num_classes, attn_impl=attn_impl,
                                compute_dtype=compute_dtype)
    eval_step = step_lib.cached_eval_step(cfg, recipe.task_config, dev)
    mask_plans = model_lib.precompute_mask_plans(ts.masks)
    ds = _DirectoryDataset(images_dir, recipe.img_size)
    batches = pipeline.BatchIterator(ds, recipe.batch_size, shuffle=False,
                                     drop_last=False, pad_last=True)
    os.makedirs(out_dir, exist_ok=True)
    written: list[str] = []
    instance_records: dict[str, list] = {}
    panoptic_preds: list[tuple] = []
    file_iter = iter(ds.files)
    for batch in batches.epoch(0):
        valid = batch.pop("valid")
        result = eval_step(ts, pipeline.to_device(batch, dev), mask_plans)
        preds = result["pred"].cpu().numpy().astype(np.uint8)
        probs = result["prob"].cpu().numpy() if save_instances else None
        embs = (result["embeddings"]
                if save_instances and "embeddings" in result else None)
        for i in range(preds.shape[0]):
            if not valid[i]:
                continue
            name = next(file_iter)
            base = os.path.splitext(name)[0]
            mask_path = os.path.join(out_dir, base + "_mask.png")
            cv2.imwrite(mask_path, preds[i])
            written.append(mask_path)
            if save_instances:
                id_map, recs = _decode_instances(
                    preds[i], probs[i],
                    embs[i] if embs is not None else None)
                cv2.imwrite(os.path.join(out_dir,
                                         base + "_instances.png"), id_map)
                for r in recs:
                    r.pop("segmentation", None)   # manifest stays small
                instance_records[name] = recs
            if save_panoptic:
                # panoptic fusion (stuff: per class; things: connected
                # components — without a dataset every class is a thing,
                # matching the per-class CC instance synthesis)
                pan, segs = panoptic.semantic_to_panoptic(preds[i])
                panoptic_preds.append((len(written) - 1, pan, segs))
            if save_panels:
                visualize.save_prediction(
                    batch["image"][i], np.zeros_like(preds[i]), preds[i],
                    os.path.join(out_dir, base + "_panel.png"))
    if save_panoptic:
        # panopticapi layout: per-image id2rgb PNG + segments json
        # (image ids are indices into the manifest's `files` list)
        panoptic.save_panoptic_predictions(
            panoptic_preds, os.path.join(out_dir, "panoptic"))
    manifest = os.path.join(out_dir, "predictions.json")
    with open(manifest, "w") as f:
        payload = {"files": written, "num_classes": num_classes,
                   "img_size": recipe.img_size}
        if save_instances:
            payload["instances"] = instance_records
        json.dump(payload, f)
    return written
