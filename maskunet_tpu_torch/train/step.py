"""Train and eval steps.

Counterpart of maskunet_tpu/train/step.py (`:38-258`). One loss covers the
reference's training patterns, as `TaskConfig` (ce_weight, triplet_weight,
triplet_features, ignore_index):

- semantic:            CE
- panoptic:            0.9*CE + 0.1*triplet on the f32 semantic logits
- instance (embed):    CE(ignore 255) + 0.5*triplet on the 16-d embeddings
- instance (summed):   CE on the summed-mask target (a dataset transform)

PyTorch runs eagerly, so the steps are plain functions: the attention goes
through the flash kernels on the card (K2 forward and K4 backward under
autograd, K1 in the eval step).

Data parallelism (`mesh`, `parallel/mesh.py`): every rank receives the
same global batch and takes its rows; the 'fresh' masks, the dropout keep
masks and the triplets are drawn for the global batch from the state's
generator, in lockstep on every rank, and each rank takes its rows; the
loss terms are each rank's share of the global means, BatchNorm's
statistics and the mIoU histograms are all-reduced, and so are the
gradients, so every rank runs the same AdamW update. The step on N ranks
equals the one-process step on the global batch up to the order of the
reductions. A mesh with a 'model' axis (tensor parallelism, the model's
docstring) keeps the params whole on every rank: the gradients of the
tensors that each model rank computes in slices (`model.tp_sharded`) are
nonzero on its slice only and sum over both axes; the others are whole
on every model rank of a data index and sum over 'data' only, as the
loss terms and the metrics do (model index 0's sums then go to the other
model ranks, so that all hold the same bits). The pipeline (`pipe_mesh`,
`parallel/pipeline.py`) runs the
forward as a 2-stage GPipe over `pipe_microbatches` microbatches, with one
global loss over all their outputs; a pipe mesh with a data axis (dp x pp)
composes both.

The attention-mask policy mirrors the reference's run-long mask caching:
'cached' reuses the masks in the state (drawing them once if absent),
'fresh' draws new Bernoulli masks from the state's generator every step.

Random draws: JAX splits each step's key three ways (masks, dropout,
triplets). The port has one stream, the state's generator, drawn in that
order within a step: the 'fresh' masks, the forward's dropout, then the
triplets after the forward (per microbatch under `grad_accum`). So the
port's draws are its own, not JAX's; a test or a check that needs both
packages on the same triplets injects them (`triplets=`). The eval step
draws its triplets from a generator of its own, seeded from the state's
seed, and leaves the state's generator where it was.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.distributed as dist

from maskunet_tpu_torch.core.device import exact_f32, resolve_device
from maskunet_tpu_torch.core.state import TrainState
from maskunet_tpu_torch.losses import triplet as triplet_lib
from maskunet_tpu_torch.losses.cross_entropy import cross_entropy
from maskunet_tpu_torch.models import maskattn_unet as model
from maskunet_tpu_torch.ops import metrics_ops
from maskunet_tpu_torch.parallel import mesh as mesh_lib
from maskunet_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    ce_weight: float = 1.0
    triplet_weight: float = 0.0
    triplet_features: str = "logits"      # 'logits' | 'embeddings'
    ignore_index: int | None = None       # CE ignore (255 for cityscapes)
    triplet_ignore_label: int | None = None
    triplet_samples: int = 32
    mask_policy: str = "cached"           # 'cached' | 'fresh'


def _uses_triplets(task: TaskConfig, batch: dict) -> bool:
    return task.triplet_weight > 0.0 and "instance" in batch


def _compute_loss(out: model.ModelOutput, batch: dict, task: TaskConfig,
                  generator: torch.Generator | None,
                  triplets: tuple | None = None, group=None
                  ) -> tuple[torch.Tensor, dict]:
    """`task.ce_weight * CE + task.triplet_weight * triplet`. The triplet
    term needs the batch's "instance" ids (inference batches carry none:
    CE only there); its (a_idx, p_idx, n_idx, weight) are `triplets` when
    given, else drawn from `generator` (None where no triplet term runs).
    `group` (the data axis): each term is this rank's share of the global
    mean (`cross_entropy`, `triplet_from_indices`)."""
    logits = out.semantic.float()
    ce = cross_entropy(logits, batch["label"], task.ignore_index, group)
    loss = task.ce_weight * ce
    metrics = {"ce_loss": ce}
    if _uses_triplets(task, batch):
        feats = (out.embeddings if task.triplet_features == "embeddings"
                 else logits)
        if triplets is None:
            triplets = triplet_lib.sample_triplets(
                generator, batch["instance"],
                num_samples=task.triplet_samples,
                ignore_label=task.triplet_ignore_label)
        a_idx, p_idx, n_idx, weight = (torch.as_tensor(t).to(feats.device)
                                       for t in triplets)
        tri = triplet_lib.triplet_from_indices(
            feats, a_idx.long(), p_idx.long(), n_idx.long(), weight.float(),
            group=group)
        loss = loss + task.triplet_weight * tri
        metrics["triplet_loss"] = tri
    metrics["loss"] = loss
    return loss, metrics


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _global(metrics: dict, group) -> dict:
    """The ranks' shares of each metric summed (one all-reduce): the
    global values, on every rank."""
    if group is None:
        return metrics
    keys = list(metrics)
    total = mesh_lib.all_reduce_(
        torch.stack([metrics[k].detach().float() for k in keys]), group)
    return dict(zip(keys, total.unbind()))


def make_grads_and_metrics(cfg: model.MaskAttnUNetConfig, task: TaskConfig,
                           *, mesh=None, pipe_mesh=None,
                           pipe_microbatches: int = 1) -> Callable:
    """grads_and_metrics(params, mstate, batch, masks, plans, generator,
    triplets=None) -> (grads, metrics, new_mstate): one forward in train
    mode, the loss (its triplets drawn from `generator` after the forward
    unless given), its gradients with respect to every parameter (a dict
    like `params`), and the batch mIoU. The seam of the train step (JAX's
    inner function, :124-150).

    `batch`, `masks`, `plans` and `triplets` are the global ones; under a
    data axis (`mesh`, or `pipe_mesh.data`) the rank takes its rows, the
    gradients are those of its share of the global loss (the caller
    all-reduces them) and the metrics are global. `pipe_mesh`: the
    forward is `pipeline.pipeline_apply` over `pipe_microbatches`
    microbatches."""
    data = pipe_mesh.data if pipe_mesh is not None else mesh
    group = mesh_lib.data_group(data)
    n_micro = pipe_microbatches if pipe_mesh is not None else 1

    def grads_and_metrics(params, mstate, batch, masks, plans, generator,
                          triplets=None):
        with span("train.forward"):
            n = batch["image"].shape[0]
            rows = mesh_lib.local_rows(data, n, n_micro)
            local = {k: v[rows] for k, v in batch.items()}
            if pipe_mesh is not None:
                from maskunet_tpu_torch.parallel import \
                    pipeline as pipeline_lib
                out_m, new_mstate = pipeline_lib.pipeline_apply(
                    params, mstate,
                    pipeline_lib.split_microbatches(local["image"],
                                                    n_micro),
                    cfg=cfg, mesh=pipe_mesh, masks=masks, train=True,
                    dropout_generator=generator, mask_plans=plans)
                # [M, mb, ...] -> [M*mb, ...]: `local`'s rows, in order
                out = model.ModelOutput(*(
                    None if a is None else a.reshape((-1,) + a.shape[2:])
                    for a in out_m))
            else:
                dropout_masks = None
                if group is not None:      # drawn for the global batch
                    dropout_masks = model.draw_dropout_masks(generator,
                                                             cfg, n)
                    if dropout_masks is not None:
                        dropout_masks = tuple(m[rows]
                                              for m in dropout_masks)
                lmasks, lplans = mesh_lib.shard_masks(data, masks, plans)
                out, new_mstate = model.apply(
                    params, mstate, local["image"], cfg=cfg, masks=lmasks,
                    train=True, dropout_generator=generator,
                    mask_plans=lplans, mesh=data,
                    dropout_masks=dropout_masks)
            if triplets is None and group is not None and \
                    _uses_triplets(task, batch):   # drawn for the global batch
                triplets = triplet_lib.sample_triplets(
                    generator, batch["instance"],
                    num_samples=task.triplet_samples,
                    ignore_label=task.triplet_ignore_label)
            if triplets is not None:
                triplets = [torch.as_tensor(t)[rows] for t in triplets]
            loss, metrics = _compute_loss(out, local, task, generator,
                                          triplets, group)
        with span("train.backward"):
            keys = list(params)
            grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(keys, grads)}
        metrics = _global({k: v.detach() for k, v in metrics.items()}, group)
        metrics["miou"] = metrics_ops.mean_iou(out.semantic.detach(),
                                               local["label"], cfg.c_out,
                                               group=group)
        return grads, metrics, new_mstate

    return grads_and_metrics


def _all_reduce_grads(grads: dict, group, mesh=None) -> dict:
    """The ranks' gradients summed, in one flat buffer a group: over
    `group` (the data axis), and under a 'model' axis the model-sharded
    tensors' over both axes. The replicated tensors' sums are then model
    index 0's on every model rank: each model rank computed them itself,
    and K4's dQ sums by atomics (`ops/flash_kernels.py`), so on the card
    the ranks' copies differ in their last bits and would drift apart."""
    if group is None:
        return grads
    tp = mesh is not None and mesh.model_group is not None
    parts = [(list(grads), group)]
    if tp:
        parts = [([k for k in grads if not model.tp_sharded(k)], group),
                 ([k for k in grads if model.tp_sharded(k)],
                  mesh_lib.world_group(mesh))]
    out = {}
    for i, (keys, g) in enumerate(parts):
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        mesh_lib.all_reduce_(flat, g)
        if tp and i == 0:
            lead = dist.get_global_rank(mesh.model_group, 0)
            mesh_lib.broadcast_(flat, mesh.model_group, src=lead)
        at = 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[at:at + n].view_as(grads[k])
            at += n
    return out


def make_train_step(cfg: model.MaskAttnUNetConfig, task: TaskConfig,
                    grad_accum: int = 1, mask_plans=None, *,
                    device: str | torch.device = "cuda", mesh=None,
                    pipe_mesh=None, pipe_microbatches: int = 1
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns step(ts, batch, triplets=None) -> (ts, metrics). The step
    moves the batch ({"image": [B,H,W,3] float, "label": [B,H,W] int, and
    "instance": [B,H,W] int for the triplet term}) to `device`, takes the
    gradients, steps `ts.optimizer` (which updates `ts.params` in place)
    and advances `ts`; it returns `ts` itself. `triplets`: (a_idx, p_idx,
    n_idx, weight), each [B, K], in place of the step's own draws.

    `mask_plans`: `model.precompute_mask_plans(ts.masks)`, used on the
    'cached' policy only (MUST come from the masks the state carries).

    `grad_accum > 1`: the batch splits into that many microbatches run one
    after another; their gradients are averaged into ONE optimizer update,
    the BN running stats thread through them, and the metrics are their
    means. `ts.masks` must be sized for the microbatch.

    `mesh` (`parallel.mesh.make_mesh`): data parallelism, and tensor
    parallelism over its 'model' axis; `batch` is the global batch,
    `ts.masks` are sized for the global microbatch, and `device` is this
    rank's (the module docstring says what is global).
    `pipe_mesh` with `pipe_microbatches >= 2`: the 2-stage GPipe forward
    (`parallel/pipeline.py`); dp x pp is a `pipeline.make_dp_pipe_mesh`
    pipe mesh, and `mesh` must then be None, as JAX refuses both.
    `grad_accum` composes as an outer loop: each accumulation chunk runs
    one pipeline flush of `pipe_microbatches` microbatches, and `ts.masks`
    are sized for one of those.

    Spans (`utils.profiling.span`): `train.step` around the whole call;
    inside it, a microbatch at a time, `train.forward` (the rows, the
    forward, the triplet draw and the loss) and `train.backward` (the
    gradients), then `train.optimizer` (AdamW and the schedule). The
    rest is the step's self time: the batch move, the masks, the mIoU,
    the all-reduces and the metrics."""
    if pipe_mesh is not None:
        from maskunet_tpu_torch.parallel import pipeline as pipeline_lib
        pipeline_lib.validate_pipe_mesh(pipe_mesh)
        if mesh is not None:
            raise ValueError("pass DP/TP either as `mesh` (non-pipelined) "
                             "or as a ('data', 'pipe') `pipe_mesh` "
                             "(pipeline.make_dp_pipe_mesh), not both")
        if pipe_microbatches < 2:
            raise ValueError("pipe_microbatches must be >= 2 with a "
                             "pipe_mesh (1 microbatch has no overlap)")
    else:
        pipe_microbatches = 1
    mesh_lib.check_process_mesh(mesh)
    group = mesh_lib.data_group(pipe_mesh.data if pipe_mesh is not None
                                else mesh)
    dev = resolve_device(device)
    exact_f32()
    grads_and_metrics = make_grads_and_metrics(
        cfg, task, mesh=mesh, pipe_mesh=pipe_mesh,
        pipe_microbatches=pipe_microbatches)

    def _step(ts: TrainState, batch: dict, triplets: tuple | None
              ) -> tuple[TrainState, dict]:
        batch = _to_device(batch, dev)
        micro = batch["image"].shape[0] // (grad_accum * pipe_microbatches)
        if task.mask_policy == "fresh" or ts.masks is None:
            masks = model.make_attention_masks(ts.generator, micro,
                                               cfg.img_size)
            plans = None               # per-step masks: planned in the step
        else:
            masks, plans = ts.masks, mask_plans
        chunk = micro * pipe_microbatches
        mstate = ts.model_state
        grads, per_micro = None, []
        for i in range(grad_accum):
            rows = slice(i * chunk, (i + 1) * chunk)
            mb = {k: v[rows] for k, v in batch.items()}
            g, m, mstate = grads_and_metrics(
                ts.params, mstate, mb, masks, plans, ts.generator,
                None if triplets is None else [t[rows] for t in triplets])
            grads = g if grads is None else {k: grads[k] + g[k]
                                             for k in grads}
            per_micro.append(m)
        if grad_accum > 1:
            grads = {k: g / grad_accum for k, g in grads.items()}
        grads = _all_reduce_grads(grads, group, mesh)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        with span("train.optimizer"):
            for k, p in ts.params.items():
                p.grad = grads[k]
            ts.optimizer.step()
            ts.optimizer.zero_grad(set_to_none=True)
            if ts.scheduler is not None:
                ts.scheduler.step()        # the lr of the next update
        ts.step += 1
        ts.model_state = mstate
        ts.masks = masks
        return ts, metrics

    def step(ts: TrainState, batch: dict, triplets: tuple | None = None
             ) -> tuple[TrainState, dict]:
        with span("train.step"):
            return _step(ts, batch, triplets)

    return step


def _eval_generator(generator: torch.Generator) -> torch.Generator:
    """The eval step's triplet generator: seeded from `generator`'s seed
    (which its draws do not move), on its device."""
    return torch.Generator(device=generator.device).manual_seed(
        (generator.initial_seed() + 1) % 2 ** 63)


@functools.lru_cache(maxsize=16)
def cached_eval_step(cfg: model.MaskAttnUNetConfig, task: TaskConfig,
                     device: str | torch.device = "cuda",
                     mesh=None) -> Callable:
    """One eval step per (cfg, task, device, mesh), shared by the training
    loop's in-training validation, `loop.evaluate` and the evaluators (JAX
    memoises its jitted step the same way; here it saves rebuilding the
    closure)."""
    return make_eval_step(cfg, task, device=device, mesh=mesh)


def make_eval_step(cfg: model.MaskAttnUNetConfig, task: TaskConfig, *,
                   device: str | torch.device = "cuda", mesh=None
                   ) -> Callable[..., dict]:
    """Eval step: running BN stats, no dropout, no autograd (so the
    attention runs K1). `step(ts, batch, mask_plans=None)` returns
    {"metrics", "pred", "prob"} (+ "embeddings"); pass
    `model.precompute_mask_plans(ts.masks)` as `mask_plans` to skip the
    per-call compaction planning. A batch's optional boolean "valid" [B]
    masks padded rows out of every metric (their labels become -1, their
    instance ids 0). The triplet term (a batch with "instance") draws from
    a generator seeded from `ts.generator`'s seed, the same draws at every
    call, as JAX draws from `fold_in(ts.rng, 1)`.

    `mesh`: the batch is the global one and each rank evaluates its rows
    (`ts.masks` sized for the global batch); the metrics are the global
    batch's, "pred", "prob" and "embeddings" this rank's rows
    (`parallel.mesh.all_gather_rows` gathers them)."""
    mesh_lib.check_process_mesh(mesh)
    group = mesh_lib.data_group(mesh)
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
            if "instance" in batch:
                batch["instance"] = torch.where(valid[:, None, None],
                                                batch["instance"], 0)
        rows = mesh_lib.local_rows(mesh, batch["image"].shape[0])
        local = {k: v[rows] for k, v in batch.items()}
        masks, mask_plans = mesh_lib.shard_masks(mesh, masks, mask_plans)
        out, _ = model.apply(ts.params, ts.model_state, local["image"],
                             cfg=cfg, masks=masks, train=False,
                             mask_plans=mask_plans, mesh=mesh)
        # a generator only where the triplet term draws from it
        generator = triplets = None
        if _uses_triplets(task, batch):
            generator = _eval_generator(ts.generator)
            if group is not None:      # drawn for the global batch
                triplets = [t[rows] for t in triplet_lib.sample_triplets(
                    generator, batch["instance"],
                    num_samples=task.triplet_samples,
                    ignore_label=task.triplet_ignore_label)]
        _, metrics = _compute_loss(out, local, task, generator, triplets,
                                   group)
        metrics = _global(metrics, group)
        metrics["miou"] = metrics_ops.mean_iou(out.semantic, local["label"],
                                               cfg.c_out, group=group)
        result = {"metrics": metrics,
                  "pred": metrics_ops.predictions(out.semantic),
                  "prob": metrics_ops.probabilities(out.semantic)}
        if out.embeddings is not None:
            result["embeddings"] = out.embeddings
        return result

    return step
