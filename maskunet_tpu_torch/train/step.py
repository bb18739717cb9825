"""Train and eval steps.

Counterpart of maskunet_tpu/train/step.py (`:38-258`). The loss is the
semantic pattern, `ce_weight * CE` (the reference's ADE/COCO/Cityscapes
semantic scripts); the triplet blends, meshes and the pipeline come with
later slices and raise here. PyTorch runs eagerly, so the steps are plain
functions: the attention goes through the flash kernels on the card (K2
forward and K4 backward under autograd, K1 in the eval step).

The attention-mask policy mirrors the reference's run-long mask caching:
'cached' reuses the masks in the state (drawing them once if absent),
'fresh' draws new Bernoulli masks from the state's generator every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from maskunet_tpu_torch.core.device import exact_f32, resolve_device
from maskunet_tpu_torch.core.state import TrainState
from maskunet_tpu_torch.losses.cross_entropy import cross_entropy
from maskunet_tpu_torch.models import maskattn_unet as model
from maskunet_tpu_torch.ops import metrics_ops


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    ce_weight: float = 1.0
    triplet_weight: float = 0.0
    triplet_features: str = "logits"      # 'logits' | 'embeddings'
    ignore_index: int | None = None       # CE ignore (255 for cityscapes)
    triplet_ignore_label: int | None = None
    triplet_samples: int = 32
    mask_policy: str = "cached"           # 'cached' | 'fresh'


def _compute_loss(out: model.ModelOutput, batch: dict, task: TaskConfig
                  ) -> tuple[torch.Tensor, dict]:
    ce = cross_entropy(out.semantic.float(), batch["label"],
                       task.ignore_index)
    loss = task.ce_weight * ce
    return loss, {"ce_loss": ce, "loss": loss}


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _check_task(task: TaskConfig, mesh, pipe_mesh) -> None:
    if task.triplet_weight > 0.0:
        raise NotImplementedError("triplet_weight > 0: loss-blends slice "
                                  "(losses/triplet.py)")
    if mesh is not None:
        raise NotImplementedError("mesh: parallel slice")
    if pipe_mesh is not None:
        raise NotImplementedError("pipe_mesh: parallel slice (GPipe)")


def make_grads_and_metrics(cfg: model.MaskAttnUNetConfig, task: TaskConfig
                           ) -> Callable:
    """grads_and_metrics(params, mstate, batch, masks, plans, generator) ->
    (grads, metrics, new_mstate): one forward in train mode, the loss, its
    gradients with respect to every parameter (a dict like `params`), and
    the batch mIoU. The seam of the train step (JAX's inner function,
    :124-150)."""

    def grads_and_metrics(params, mstate, batch, masks, plans, generator):
        out, new_mstate = model.apply(
            params, mstate, batch["image"], cfg=cfg, masks=masks, train=True,
            dropout_generator=generator, mask_plans=plans)
        loss, metrics = _compute_loss(out, batch, task)
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(keys, grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["miou"] = metrics_ops.mean_iou(out.semantic.detach(),
                                               batch["label"], cfg.c_out)
        return grads, metrics, new_mstate

    return grads_and_metrics


def make_train_step(cfg: model.MaskAttnUNetConfig, task: TaskConfig,
                    grad_accum: int = 1, mask_plans=None, *,
                    device: str | torch.device = "cuda", mesh=None,
                    pipe_mesh=None
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns step(ts, batch) -> (ts, metrics). The step moves the batch
    ({"image": [B,H,W,3] float, "label": [B,H,W] int}) to `device`, takes
    the gradients, steps `ts.optimizer` (which updates `ts.params` in
    place) and advances `ts`; it returns `ts` itself.

    `mask_plans`: `model.precompute_mask_plans(ts.masks)`, used on the
    'cached' policy only (MUST come from the masks the state carries).

    `grad_accum > 1`: the batch splits into that many microbatches run one
    after another; their gradients are averaged into ONE optimizer update,
    the BN running stats thread through them, and the metrics are their
    means. `ts.masks` must be sized for the microbatch."""
    _check_task(task, mesh, pipe_mesh)
    dev = resolve_device(device)
    exact_f32()
    grads_and_metrics = make_grads_and_metrics(cfg, task)

    def step(ts: TrainState, batch: dict) -> tuple[TrainState, dict]:
        batch = _to_device(batch, dev)
        micro = batch["image"].shape[0] // grad_accum
        if task.mask_policy == "fresh" or ts.masks is None:
            masks = model.make_attention_masks(ts.generator, micro,
                                               cfg.img_size)
            plans = None               # per-step masks: planned in the step
        else:
            masks, plans = ts.masks, mask_plans
        mstate = ts.model_state
        grads, per_micro = None, []
        for i in range(grad_accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            g, m, mstate = grads_and_metrics(ts.params, mstate, mb, masks,
                                             plans, ts.generator)
            grads = g if grads is None else {k: grads[k] + g[k]
                                             for k in grads}
            per_micro.append(m)
        if grad_accum > 1:
            grads = {k: g / grad_accum for k, g in grads.items()}
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        for k, p in ts.params.items():
            p.grad = grads[k]
        ts.optimizer.step()
        ts.optimizer.zero_grad(set_to_none=True)
        ts.step += 1
        ts.model_state = mstate
        ts.masks = masks
        return ts, metrics

    return step


def make_eval_step(cfg: model.MaskAttnUNetConfig, task: TaskConfig, *,
                   device: str | torch.device = "cuda", mesh=None
                   ) -> Callable[..., dict]:
    """Eval step: running BN stats, no dropout, no autograd (so the
    attention runs K1). `step(ts, batch, mask_plans=None)` returns
    {"metrics", "pred", "prob"} (+ "embeddings"); pass
    `model.precompute_mask_plans(ts.masks)` as `mask_plans` to skip the
    per-call compaction planning. A batch's optional boolean "valid" [B]
    masks padded rows out of every metric (their labels become -1)."""
    _check_task(task, mesh, None)
    dev = resolve_device(device)
    exact_f32()

    @torch.no_grad()
    def step(ts: TrainState, batch: dict, mask_plans=None) -> dict:
        batch = _to_device(batch, dev)
        masks = ts.masks
        if masks is None:
            masks = model.make_attention_masks(
                ts.generator, batch["image"].shape[0], cfg.img_size)
            mask_plans = None          # per-call masks: planned here
        valid = batch.get("valid")
        if valid is not None:
            batch["label"] = torch.where(valid[:, None, None],
                                         batch["label"], -1)
        out, _ = model.apply(ts.params, ts.model_state, batch["image"],
                             cfg=cfg, masks=masks, train=False,
                             mask_plans=mask_plans)
        _, metrics = _compute_loss(out, batch, task)
        metrics["miou"] = metrics_ops.mean_iou(out.semantic, batch["label"],
                                               cfg.c_out)
        result = {"metrics": metrics,
                  "pred": metrics_ops.predictions(out.semantic),
                  "prob": metrics_ops.probabilities(out.semantic)}
        if out.embeddings is not None:
            result["embeddings"] = out.embeddings
        return result

    return step
