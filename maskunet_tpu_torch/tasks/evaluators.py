"""Task-level evaluation flows: semantic mIoU, instance AP, panoptic PQ/AP.

Counterpart of maskunet_tpu/tasks/evaluators.py: the reference's three
evaluation call stacks on top of the eval step (on the card unless the
caller asks for the CPU) and the host-side evaluation stack:

The semantic flow (val loss + mIoU, ade_semantic.py:439-474) is
`train.loop.evaluate`.
- `evaluate_instances`: predictions -> temperature-softmax probs -> argmax
  -> connected-component instances scored by mean class probability,
  ground truth instances from the semantic mask (ADE pattern,
  ade_instance.py:399-457), the instance-id map (Cityscapes pattern,
  city_instance.py:451-513) or the ragged per-annotation masks (COCO);
  DBSCAN of the embeddings where the model has them; COCO-style segm AP
  with a max_queries sweep.
- `evaluate_panoptic`: per-image IoU + instance AP at iouThrs 0.5:0.95
  (ade_panoptic.py:520-592) + PQ via panoptic fusion, decoded on 4 host
  threads while the next batch runs on the device.

Records are keyed by the dataset's image ids (COCO's json ids; the
dataset index elsewhere).
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from maskunet_tpu_torch.core.device import resolve_device
from maskunet_tpu_torch.data import coco as coco_data
from maskunet_tpu_torch.data import pipeline
from maskunet_tpu_torch.evaluation import (clustering, coco_eval, instances,
                                           panoptic)
from maskunet_tpu_torch.evaluation import rle as rle_lib
from maskunet_tpu_torch.models import maskattn_unet as model_lib
from maskunet_tpu_torch.tasks.datasets import make_datasets
from maskunet_tpu_torch.tasks.recipes import Recipe
from maskunet_tpu_torch.train import loop as loop_lib
from maskunet_tpu_torch.train import step as step_lib


def _eval_dataset(recipe: Recipe, data_root: str | None,
                  split: str = "val"):
    """Returns (dataset, num_classes) for evaluation. `split='train'`
    reproduces the reference's quirk of evaluating Cityscapes instances on
    the train loader (city_instance.py:510)."""
    train_ds, val_ds, num_classes = make_datasets(recipe, data_root)
    return (train_ds if split == "train" else val_ds), num_classes


def _iter_eval(recipe: Recipe, ds, num_classes: int, ts, *,
               attn_impl: str = "auto", max_batches: int | None = None,
               compute_dtype: str = "float32",
               device: str | torch.device = "cuda"):
    """Yields (dataset indices, image ids, host dict) per batch. Host: numpy
    pred/prob/label/valid[/instance], and the embeddings (if the model has
    them) as a tensor left on `device`, where the DBSCAN runs. Rows beyond
    the dataset end (pad_last) are excluded via host['valid']. The step
    comes from `step_lib.cached_eval_step`, shared with the loop's
    validation."""
    dev = resolve_device(device)
    cfg = loop_lib.model_config(recipe, num_classes, attn_impl=attn_impl,
                                compute_dtype=compute_dtype)
    eval_step = step_lib.cached_eval_step(cfg, recipe.task_config, dev)
    # compaction plans once per eval run, not once per batch
    mask_plans = model_lib.precompute_mask_plans(ts.masks)
    batches = pipeline.BatchIterator(ds, recipe.batch_size,
                                     shuffle=False, drop_last=False,
                                     pad_last=True)
    n = len(ds)
    for i, batch in enumerate(batches.epoch(0)):
        result = eval_step(ts, pipeline.to_device(batch, dev), mask_plans)
        host = {
            "pred": result["pred"].cpu().numpy(),
            "prob": result["prob"].cpu().numpy(),
            "label": batch["label"],
            "valid": batch["valid"],
        }
        if "instance" in batch:
            host["instance"] = batch["instance"]
        if "embeddings" in result:
            host["embeddings"] = result["embeddings"]
        indices = [min(i * recipe.batch_size + b, n - 1)
                   for b in range(host["pred"].shape[0])]
        yield indices, [int(ds.image_id(j)) for j in indices], host
        if max_batches is not None and i + 1 >= max_batches:
            return


def _ragged_coco_gt(recipe: Recipe, data_root: str, split: str):
    """Ragged ground-truth twin for the coco_instance recipe: real
    per-annotation masks + category ids of `split` (the training target
    is the reference's summed-mask map, whose values are overlap counts —
    wrong as evaluation gt; the reference's own final eval is broken
    here, coco_instance.py:386-413). Returns a function of the dataset
    index."""
    ann = os.path.join(data_root, "annotations")
    if split == "train":
        ds = coco_data.COCOInstanceDataset(
            os.path.join(ann, "instances_train2017.json"),
            os.path.join(data_root, "train_subset"),
            img_size=recipe.img_size, summed_target=False)
    else:
        ds = coco_data.COCOInstanceDataset(
            os.path.join(ann, "instances_val2017.json"),
            os.path.join(data_root, "val2017"), img_size=recipe.img_size,
            summed_target=False)

    def gt_for(index: int) -> list[dict]:
        ex = ds[index]
        out = []
        for m, cat in zip(ex["masks"], ex["labels"]):
            ys, xs = np.nonzero(m)
            if len(ys) == 0:
                continue
            out.append({
                "category_id": int(cat),
                "bbox": [int(xs.min()), int(ys.min()),
                         int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)],
                "score": 1.0,
                "area": int(m.sum()),
                "segmentation": rle_lib.encode(m.astype(np.uint8)),
            })
        return out

    return gt_for


def evaluate_instances(recipe: Recipe, data_root: str | None, ts, *,
                       max_queries: tuple[int, ...] | None = None,
                       max_batches: int | None = None,
                       attn_impl: str = "auto",
                       compute_dtype: str = "float32",
                       split: str = "val",
                       dataset: tuple | None = None,
                       device: str | torch.device = "cuda"
                       ) -> dict[int, dict]:
    """Instance AP with the reference's max_queries sweep
    (ade_instance.py:451-457: 50/100/150/200; city_instance.py:510:
    30/50/70/100). Returns {max_queries: summarize() stats}.

    `split`: 'val', or 'train' for the reference's Cityscapes quirk (the
    train split, city_instance.py:510; `cli evaluate --split`).
    `dataset`: optional prebuilt (ds, num_classes) of the validation split
    — the training loop passes its cached val set so in-training eval
    skips reconstruction.

    Predicted instances come from the DBSCAN of the embeddings when the
    recipe has an embedding head, else from connected components. The
    coco_instance recipe scores every instance as category 1, since its
    training target's "classes" are overlap counts (coco_instance.py:
    331-341), as the reference's own final eval does (:395-403)."""
    if max_queries is None:
        max_queries = recipe.eval_max_queries
    class_agnostic = recipe.dataset == "coco" and recipe.task == "instance"
    ragged_gt = None
    if class_agnostic and data_root is not None:
        ragged_gt = _ragged_coco_gt(recipe, data_root, split)
    if dataset is not None and split == "val":
        ds, num_classes = dataset
    else:
        ds, num_classes = _eval_dataset(recipe, data_root, split)
    gts: list[dict] = []
    dts: list[dict] = []
    for indices, ids, host in _iter_eval(
            recipe, ds, num_classes, ts, attn_impl=attn_impl,
            max_batches=max_batches, compute_dtype=compute_dtype,
            device=device):
        for b in range(host["pred"].shape[0]):
            if not host["valid"][b]:
                continue
            img_id = ids[b]
            pred, prob = host["pred"][b], host["prob"][b]
            if "embeddings" in host:
                masks = clustering.instances_from_embeddings(
                    pred, host["embeddings"][b])
                pred_inst = clustering.annotate_instances(masks, pred)
            else:
                pred_inst = instances.get_instances_from_mask(pred, prob)
            if ragged_gt is not None:
                gt_inst = ragged_gt(indices[b])
            elif "instance" in host:
                gt_inst = instances.instances_from_id_map(
                    host["instance"][b], host["label"][b])
            else:
                gt_inst = instances.get_instances_from_mask(host["label"][b])
            if class_agnostic:
                gt_inst = [{**g, "category_id": 1} for g in gt_inst]
                pred_inst = [{**d, "category_id": 1} for d in pred_inst]
            for g in gt_inst:
                gts.append({**g, "image_id": img_id})
            for d in pred_inst:
                dts.append({**d, "image_id": img_id})

    results = {}
    for q in max_queries:
        by_img: dict[int, list] = {}
        for d in dts:
            by_img.setdefault(d["image_id"], []).append(d)
        capped = [d for lst in by_img.values()
                  for d in instances.top_k_by_score(lst, q)]
        results[q] = coco_eval.evaluate_ap(gts, capped)
    return results


def evaluate_panoptic(recipe: Recipe, data_root: str | None, ts, *,
                      things: set[int] | None = None,
                      max_batches: int | None = None,
                      attn_impl: str = "auto",
                      compute_dtype: str = "float32",
                      export_dir: str | None = None,
                      dataset: tuple | None = None,
                      device: str | torch.device = "cuda") -> dict:
    """AP (segm, iouThrs 0.5:0.95) + PQ All/Things/Stuff + mean IoU —
    the tuple the reference prints (ade_panoptic.py:588-592).

    `things=None` takes the things/stuff split from the dataset
    (`things_labels`; the synthetic set treats every class but 0 as a
    thing). `dataset`: optional prebuilt (ds, num_classes), as in
    `evaluate_instances`."""
    if dataset is not None:
        ds, num_classes = dataset
    else:
        ds, num_classes = _eval_dataset(recipe, data_root)
    if things is None:
        things = getattr(ds, "things_labels", None)

    def process_image(img_id, pred, label, prob, gt_inst):
        """Host-side decode for one image: IoU, CC instances, panoptic
        fusion. Runs on a worker thread so it overlaps the next batch's
        device eval (the native CC/IoU calls release the GIL)."""
        # per-image IoU (compute_iou_for_image, ade_panoptic.py:182-192)
        present = [
            (np.sum((pred == c) & (label == c)),
             np.sum((pred == c) | (label == c)))
            for c in range(num_classes)]
        per_cls = [i / u for i, u in present if u > 0]
        iou = float(np.mean(per_cls)) if per_cls else 1.0
        # instance AP from connected components (reference pattern)
        g_inst = [{**g, "image_id": img_id}
                  for g in instances.get_instances_from_mask(label)]
        d_inst = [{**d, "image_id": img_id}
                  for d in instances.get_instances_from_mask(pred, prob)]
        gt_pan, gt_segs = panoptic.semantic_to_panoptic(
            label, gt_inst, things=things)
        pred_pan, pred_segs = panoptic.semantic_to_panoptic(
            pred, None, things=things)
        return (iou, g_inst, d_inst,
                (gt_pan, gt_segs, pred_pan, pred_segs),
                (img_id, pred_pan, pred_segs))

    futures = []
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for _, ids, host in _iter_eval(
                recipe, ds, num_classes, ts, attn_impl=attn_impl,
                max_batches=max_batches, compute_dtype=compute_dtype,
                device=device):
            gt_inst = host.get("instance")
            for b in range(host["pred"].shape[0]):
                if not host["valid"][b]:
                    continue
                futures.append(pool.submit(
                    process_image, ids[b], host["pred"][b],
                    host["label"][b], host["prob"][b],
                    gt_inst[b] if gt_inst is not None else None))
        results = [f.result() for f in futures]   # submission order

    gts: list[dict] = []
    dts: list[dict] = []
    pq_images = []
    export_preds: list[tuple] = []
    ious: list[float] = []
    for iou, g_inst, d_inst, pq_img, export in results:
        ious.append(iou)
        gts.extend(g_inst)
        dts.extend(d_inst)
        pq_images.append(pq_img)
        export_preds.append(export)

    if export_dir is not None:
        panoptic.save_panoptic_predictions(export_preds, export_dir)
    ap_stats = coco_eval.evaluate_ap(gts, dts)
    pq_stats = panoptic.pq_compute(pq_images, things=things)
    return {
        "ap": ap_stats,
        "pq": pq_stats,
        "miou": float(np.mean(ious)) if ious else 0.0,
    }
