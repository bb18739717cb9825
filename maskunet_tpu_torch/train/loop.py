"""The training loop: epochs, cadenced checkpoints, early stop, logging.

Counterpart of maskunet_tpu/train/loop.py: per-batch metric accumulation
one step behind the card, intra-epoch periodic prints and checkpoint
saves, a per-epoch 'latest' checkpoint, EarlyStopping on training loss
saving 'best', the overfit circuit breaker on mIoU, in-loop validation,
a prefetched input pipeline, jsonl metrics and an images/sec meter.

In-training validation gives loss and mIoU, and for panoptic recipes
PQ and AP, for instance recipes AP at the last of `eval_max_queries`
(`tasks/evaluators.py`, on the cached validation set).

`mesh` (`parallel.mesh.make_mesh` in a process group): data parallelism,
this process being one rank. Every rank builds the same state, which is
then rank 0's on all (`put_replicated`, after init, restore and warm
start); every rank reads the same global batches and the step takes its
rows; validation runs under the mesh. Only rank 0 writes checkpoints and
logs, as JAX's process 0: the others wait for it at a barrier at each
epoch's end and before returning, where JAX's processes wait at their
next collective. `pipeline_microbatches > 1`: the 2-stage GPipe
(`parallel/pipeline.py`), on `make_pipe_mesh()` or on `mesh` when it has
the pipe axis (dp x pp from `make_dp_pipe_mesh`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from maskunet_tpu_torch.core import checkpoint as ckpt_lib
from maskunet_tpu_torch.core import metrics_log, state as state_lib
from maskunet_tpu_torch.core.device import resolve_device
from maskunet_tpu_torch.core.loop_control import EarlyStopping, OverfitGuard
from maskunet_tpu_torch.data import pipeline
from maskunet_tpu_torch.models import maskattn_unet as model_lib
from maskunet_tpu_torch.parallel import mesh as mesh_lib
from maskunet_tpu_torch.tasks.datasets import make_datasets
from maskunet_tpu_torch.tasks.recipes import Recipe
from maskunet_tpu_torch.train import step as step_lib


@dataclasses.dataclass
class TrainResult:
    state: state_lib.TrainState
    history: list[dict]
    best_loss: float
    best_iou: float
    images_per_sec: float
    # why the run ended: "completed" (epoch budget exhausted), "max_steps",
    # "early_stop" (patience on train loss), or "overfit_guard" (mIoU
    # circuit breaker)
    stop_reason: str = "completed"
    # keep_best_state=True: the state at the EarlyStopping best-loss epoch
    # (params and BN statistics) — None when the option is off or no epoch
    # ever improved
    best_state: state_lib.TrainState | None = None
    # seconds the checkpoint saves held the loop (snapshots, joins)
    save_blocked_s: float = 0.0


# optax's schedules as multipliers of the recipe's lr at update n; optax
# reads its count before the increment, as LambdaLR gives update n the
# factor at n (so warmup_cosine's first update has lr 0)

def _cosine(n: int, decay_steps: int) -> float:
    """optax.cosine_decay_schedule(1, decay_steps)."""
    return 0.5 * (1 + math.cos(math.pi * min(n, decay_steps) / decay_steps))


def _warmup_cosine(n: int, warmup: int, total: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, 1, warmup, total): linear from
    0 over `warmup` updates, then the cosine over the rest."""
    if n < warmup:
        return n / warmup
    return _cosine(n - warmup, total - warmup)


def _staircase(n: int, every: int) -> float:
    """optax.exponential_decay(1, every, 0.1, staircase=True)."""
    return 0.1 ** (n // every)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(lr or a schedule, weight_decay) as torch AdamW, term for
    term: betas (0.9, 0.999), eps 1e-8 outside the square root, decoupled
    decay on every parameter. Called on the parameters it builds the
    optimizer (on their device); `scheduler` builds the LambdaLR of the
    schedule over it, or None at a constant lr."""
    lr: float
    weight_decay: float
    schedule: Callable[[int], float] | None = None

    def __call__(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)

    def scheduler(self, optimizer: torch.optim.Optimizer
                  ) -> torch.optim.lr_scheduler.LambdaLR | None:
        if self.schedule is None:
            return None
        return torch.optim.lr_scheduler.LambdaLR(optimizer, self.schedule)


def make_optimizer(recipe: Recipe, *, lr_schedule: str | None = None,
                   total_steps: int | None = None,
                   warmup_steps: int = 0) -> AdamW:
    """AdamW at the recipe's lr with an optional schedule, as a factory
    over the parameters (`state_lib.create` calls it). The decay is passed
    explicitly: torch's default is 0.01, optax's 1e-4. The schedules need
    `total_steps` (the loop computes it from the dataset size and epoch
    budget)."""
    if lr_schedule is None:
        schedule = None
    elif total_steps is None:
        raise ValueError("lr_schedule requires total_steps")
    elif lr_schedule == "cosine":
        schedule = functools.partial(_cosine, decay_steps=max(total_steps, 1))
    elif lr_schedule == "warmup_cosine":
        warmup = max(warmup_steps, 1)
        schedule = functools.partial(
            _warmup_cosine, warmup=warmup,
            total=max(total_steps, warmup_steps + 1))
    elif lr_schedule == "step":
        # reference-style StepLR: x0.1 every third of the run
        schedule = functools.partial(_staircase,
                                     every=max(total_steps // 3, 1))
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}; "
                         "use cosine | warmup_cosine | step")
    return AdamW(recipe.lr, recipe.weight_decay, schedule)


def model_config(recipe: Recipe, num_classes: int, *,
                 attn_impl: str = "auto",
                 compute_dtype: str = "float32",
                 remat_attention: bool = False
                 ) -> model_lib.MaskAttnUNetConfig:
    return model_lib.MaskAttnUNetConfig(
        c_out=num_classes, img_size=recipe.img_size,
        embed_dim=recipe.embed_dim,
        with_boundary_head=recipe.with_boundary_head,
        attn_impl=attn_impl, compute_dtype=compute_dtype,
        remat_attention=remat_attention,
        attn_output_layout=recipe.attn_output_layout)


def setup_state(recipe: Recipe, cfg: model_lib.MaskAttnUNetConfig,
                optimizer, *, batch_size: int | None = None,
                device: str | torch.device = "cuda"
                ) -> state_lib.TrainState:
    """Weights and cached masks drawn from the recipe's seed (the same
    draws `serve.build_inference_fn` makes), moved to `device`, with a
    generator on `device` for dropout seeded from the same stream."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(recipe.seed)
    params, mstate = model_lib.init(gen, cfg)
    masks = model_lib.make_attention_masks(
        gen, batch_size or recipe.batch_size, cfg.img_size)
    seed = int(torch.randint(2 ** 62, (1,), generator=gen))
    return state_lib.create(
        torch.Generator(device=dev).manual_seed(seed),
        {k: v.to(dev) for k, v in params.items()},
        {k: v.to(dev) for k, v in mstate.items()}, optimizer,
        masks=tuple(m.to(dev) for m in masks))


class _HostMetrics:
    """A step's metrics on their way to the host: one non-blocking copy of
    all of them into pinned memory, read by `values()` after its event
    (a step later, when the copy has long landed)."""

    def __init__(self, metrics: dict[str, torch.Tensor]):
        self.keys = list(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(())
                              for k in self.keys])
        self.event = None
        if values.is_cuda:
            self.host = torch.empty(values.shape, dtype=values.dtype,
                                    pin_memory=True)
            self.host.copy_(values, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = values

    def values(self) -> dict[str, float]:
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(self.keys, self.host.tolist()))


def run_device(mesh, device) -> torch.device:
    """The device this process runs on: its rank's under a process group,
    else `device`."""
    if mesh_lib.data_group(mesh) is not None:
        return resolve_device(mesh.device)
    return resolve_device(device)


def _pipe_mesh(mesh, dev: torch.device):
    """The pipeline's mesh: `mesh` when it has the pipe axis (dp x pp), or
    the first two cards; on the CPU both stages run on it, as JAX's CPU
    runs use virtual devices."""
    from maskunet_tpu_torch.parallel import pipeline as pp_lib
    if mesh is not None:
        return pp_lib.validate_pipe_mesh(mesh)
    return pp_lib.make_pipe_mesh(devices=[dev, dev] if dev.type == "cpu"
                                 else None)


def train(recipe: Recipe, data_root: str | None, workdir: str, *,
          max_steps: int | None = None, max_epochs: int | None = None,
          mesh=None, attn_impl: str = "auto",
          compute_dtype: str = "float32", remat_attention: bool = False,
          resume: bool = False,
          grad_accum: int = 1,
          pipeline_microbatches: int = 1,
          lr_schedule: str | None = None, warmup_steps: int = 0,
          log_every: int = 500, ckpt_every: int = 2000,
          num_io_threads: int = 4, verbose: bool = True,
          data_fraction: float = 1.0,
          debug_nan: bool = False,
          eval_every: int | None = None,
          eval_max_batches: int = 8,
          init_from: str | None = None,
          init_drop: tuple[str, ...] = (),
          cache_examples: bool = True,
          save_checkpoints: bool = True,
          keep_best_state: bool = False,
          step_timeout: float | None = None,
          step_timeout_abort: bool = False,
          profile_dir: str | None = None,
          profile_steps: int = 5,
          device: str | torch.device = "cuda") -> TrainResult:
    """JAX's `train` with the same arguments, on `device` (the card unless
    the caller asks for the CPU).

    One divergence: `max_epochs` and `max_steps` count the whole run. A
    resumed run starts at the epoch its checkpoint's step falls in and
    counts steps from that step, so it ends where an uninterrupted run
    would (JAX's loop restarts both counts at 0 after a resume). A fresh
    run is the same in both.

    `mesh` and `pipeline_microbatches`: the module docstring. Under a
    process group `device` is the rank's own, `mesh.device`."""
    pp_micro = max(pipeline_microbatches, 1)
    pipe_mesh = None
    if pp_micro > 1:
        # the mesh moves whole to the pipeline executor, as JAX's does
        pipe_mesh = _pipe_mesh(mesh, resolve_device(device))
        mesh = None
        dev = resolve_device(pipe_mesh.devices[0])
    else:
        dev = run_device(mesh, device)
    data = pipe_mesh.data if pipe_mesh is not None else mesh
    lead = mesh_lib.is_lead(data)
    save_lead = lead and save_checkpoints
    train_ds, val_ds, num_classes = make_datasets(recipe, data_root)
    if data_fraction < 1.0:
        from maskunet_tpu_torch.data.subset import FractionSubset
        train_ds = FractionSubset(train_ds, data_fraction, seed=recipe.seed)
    if cache_examples:
        from maskunet_tpu_torch.data.cache import CachedDataset
        train_ds = CachedDataset(train_ds)
        val_ds = CachedDataset(val_ds)
    cfg = model_config(recipe, num_classes, attn_impl=attn_impl,
                       compute_dtype=compute_dtype,
                       remat_attention=remat_attention)
    epochs = max_epochs if max_epochs is not None else recipe.num_epochs
    # grad_accum and the pipeline's microbatches: a step consumes
    # micro_per_step batches of recipe.batch_size (the masks' size)
    micro_per_step = grad_accum * pp_micro
    steps_per_epoch = max(
        len(train_ds) // (recipe.batch_size * micro_per_step), 1)
    optimizer = make_optimizer(
        recipe, lr_schedule=lr_schedule, warmup_steps=warmup_steps,
        total_steps=(max_steps if max_steps is not None
                     else epochs * steps_per_epoch))
    ts = setup_state(recipe, cfg, optimizer, device=dev)

    if init_from is not None:
        # cross-task warm start: matching leaves from another run's
        # checkpoint; `init_drop` prefixes and shape mismatches stay fresh
        skipped = ckpt_lib.warm_start(
            ts, ckpt_lib.restore_raw(init_from)["params"], init_drop)
        if verbose and lead:
            print(f"warm start from {init_from}; "
                  f"{len(skipped)} leaves kept fresh")

    manager = ckpt_lib.CheckpointManager(workdir, recipe.checkpoint_name)
    if resume and manager.has("latest"):
        ts = manager.restore(ts, "latest")
        if verbose and lead:
            print(f"resumed from step {ts.step}")
    # every rank holds rank 0's state from here on
    mesh_lib.put_replicated(data, ts)

    # compaction plans from the masks the state ACTUALLY carries, after
    # the restore and the warm start settled them
    mask_plans = model_lib.precompute_mask_plans(ts.masks)
    train_step = step_lib.make_train_step(
        cfg, recipe.task_config, grad_accum=grad_accum,
        mask_plans=mask_plans, device=dev, mesh=mesh, pipe_mesh=pipe_mesh,
        pipe_microbatches=pp_micro)
    # only the lead writes logs (the others would race on its files)
    logger = (metrics_log.MetricsLogger(workdir, f"train_{recipe.name}")
              if lead else None)
    meter = metrics_log.Throughput()
    # `current` indirection: the callback saves the state at call time
    current: dict[str, Any] = {"ts": ts}
    # keep_best_state: device-side clones of (params, BN stats) at each
    # best-loss epoch, not a host copy
    best_snap: dict[str, Any] = {}

    def _on_improve() -> None:
        if save_lead:
            manager.save_best(current["ts"])
        if keep_best_state:
            best_snap["pm"] = (
                {k: v.detach().clone() for k, v in current["ts"].params
                 .items()},
                {k: v.clone() for k, v in current["ts"].model_state.items()})

    early = EarlyStopping(recipe.patience, verbose=verbose and lead,
                          on_improve=_on_improve)
    guard = OverfitGuard(recipe.overfit_margin)

    # every rank reads the same global batches (the same seed): the step
    # takes its rows on the device
    batches = pipeline.BatchIterator(
        train_ds, recipe.batch_size * micro_per_step, shuffle=True,
        seed=recipe.seed, drop_last=True, num_threads=num_io_threads)
    history: list[dict] = []
    best_loss, best_iou = float("inf"), 0.0
    steps_done = ts.step
    first_epoch = min(ts.step // steps_per_epoch, epochs)

    # torch.profiler window: skip the first 2 steps of this run (kernel
    # builds and cuDNN plans pollute the trace), trace `profile_steps`
    profile_start = (steps_done + 2 if profile_dir is not None and lead
                     else -1)
    profiler = None

    def _maybe_profile():
        nonlocal profiler
        if steps_done == profile_start:
            from maskunet_tpu_torch.utils.profiling import trace
            _sync(dev)              # trace only steady-state work
            profiler = trace(profile_dir)
            profiler.__enter__()
        elif profiler is not None and \
                steps_done >= profile_start + profile_steps:
            _sync(dev)
            profiler.__exit__(None, None, None)
            profiler = None
            if verbose and lead:
                print(f"device trace ({profile_steps} steps) -> "
                      f"{profile_dir}")

    # Metric consumption trails the step by one: reading a device value
    # waits for the card, which would serialize host dispatch with device
    # work. Each step's metrics start one non-blocking copy to pinned
    # memory, read on the NEXT iteration when it has long landed. Totals
    # are exact: every step is consumed, the last by the epoch flush.
    # debug_nan opts out (a NaN should name the step that made it).
    def _consume(values: dict, acc: dict) -> None:
        acc["total_loss"] += values["loss"]
        acc["total_iou"] += values["miou"]
        acc["count"] += 1

    # step_timeout: fail-fast on a hung device step; the watchdog warns,
    # or exits 42 for a supervisor to restart with resume. The epoch-end
    # validation/checkpoint window is paused. Torn down on every exit.
    watchdog = None
    beat = lambda *_: None   # noqa: E731
    if step_timeout:
        from maskunet_tpu_torch.utils.profiling import StallWatchdog
        watchdog = StallWatchdog(step_timeout, abort=step_timeout_abort)
        watchdog.__enter__()
        beat = watchdog.beat

    stop_reason = "completed"
    try:
        for epoch in range(first_epoch, epochs):
            acc = {"total_loss": 0.0, "total_iou": 0.0, "count": 0}
            lagged = None   # the previous step's metrics, in flight
            with pipeline.Prefetcher(batches.epoch(epoch),
                                     device=dev) as prefetcher:
                for i, batch in enumerate(prefetcher):
                    batch.pop("valid", None)
                    ts, metrics = train_step(ts, batch)
                    current["ts"] = ts
                    meter.step(recipe.batch_size * micro_per_step)
                    if debug_nan:
                        from maskunet_tpu_torch.utils.profiling import \
                            nan_guard
                        nan_guard(metrics, f"step {steps_done}")
                        _consume(_HostMetrics(metrics).values(), acc)
                    else:
                        pending = _HostMetrics(metrics)
                        if lagged is not None:
                            _consume(lagged.values(), acc)
                        lagged = pending
                    steps_done += 1
                    # progress = the step was dispatched AND the lagged
                    # read above returned — exactly what a hung card blocks
                    beat(f"epoch {epoch + 1} step {steps_done}")
                    if profile_start >= 0:
                        _maybe_profile()
                    if log_every and i % log_every == 0 and i != 0 \
                            and verbose and lead and acc["count"]:
                        print(f"epoch {epoch + 1}: batch[{i}] "
                              f"loss {acc['total_loss'] / acc['count']:.4f} "
                              f"iou {acc['total_iou'] / acc['count']:.4f}")
                    if ckpt_every and i % ckpt_every == 0 and i != 0 \
                            and save_lead:
                        manager.save_latest(ts)
                    if max_steps is not None and steps_done >= max_steps:
                        break
            if lagged is not None:
                _consume(lagged.values(), acc)
            count = acc["count"]
            if count == 0:
                raise ValueError(
                    f"epoch produced no batches: train set has {len(train_ds)} "
                    f"examples < batch size {recipe.batch_size} (drop_last)")
            avg_loss = acc["total_loss"] / count
            avg_iou = acc["total_iou"] / count
            best_loss = min(best_loss, avg_loss)
            best_iou = max(best_iou, avg_iou)
            record = {"epoch": epoch + 1, "loss": avg_loss, "miou": avg_iou,
                      "step": steps_done,
                      "images_per_sec": round(meter.images_per_sec(), 2)}
            # the epoch-end window (validation, checkpoint snapshots) is
            # legitimately slower than a step timeout sized for the loop
            if watchdog is not None:
                watchdog.pause(f"epoch {epoch + 1} end "
                               f"(validation/checkpoint window)")
            if eval_every and (epoch + 1) % eval_every == 0:
                # periodic in-training validation over eval_max_batches *
                # batch_size images (the sample size is recorded beside it)
                val = _evaluate_state(recipe, cfg, ts, val_ds, device=dev,
                                      mesh=mesh, max_batches=eval_max_batches)
                record.update({f"val_{k}": v for k, v in val.items()})
                record["val_sample_images"] = min(
                    eval_max_batches * recipe.batch_size, len(val_ds))
                record.update(_evaluate_task(
                    recipe, data_root, ts, (val_ds, num_classes),
                    max_batches=eval_max_batches, attn_impl=attn_impl,
                    compute_dtype=compute_dtype, device=dev, mesh=mesh))
            history.append(record)
            if logger is not None:
                logger.log(record)
            if verbose and lead:
                print(f"epoch [{epoch + 1}/{epochs}] loss {avg_loss:.4f} "
                      f"iou {avg_iou:.4f} "
                      f"({record['images_per_sec']} img/s)")
            if save_lead:
                manager.save_latest(ts)
            mesh_lib.barrier(data)   # the others wait for the lead's save

            if max_steps is not None and steps_done >= max_steps:
                stop_reason = "max_steps"
                break
            if guard(avg_iou):
                stop_reason = "overfit_guard"
                if verbose and lead:
                    print("overfit guard triggered")
                break
            # early() can save a best checkpoint (which may join the
            # previous in-flight save): inside the paused window
            if early(avg_loss):
                stop_reason = "early_stop"
                if verbose and lead:
                    print("early stopping triggered")
                break
            if watchdog is not None:
                watchdog.resume()
    finally:
        if watchdog is not None:
            watchdog.__exit__(None, None, None)
        if profiler is not None:   # the run ended inside the trace window
            profiler.__exit__(None, None, None)
    if logger is not None:
        logger.close()
    manager.wait()   # all async checkpoint writes durable before return
    mesh_lib.barrier(data)
    best_state = None
    if "pm" in best_snap:
        bp, bm = best_snap["pm"]
        best_state = dataclasses.replace(ts, params=bp, model_state=bm)
    return TrainResult(ts, history, best_loss, best_iou,
                       meter.images_per_sec(), stop_reason,
                       best_state=best_state,
                       save_blocked_s=manager.blocked_s)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _evaluate_state(recipe: Recipe, cfg, ts, val_ds, *,
                    device: torch.device, mesh=None,
                    max_batches: int | None = None) -> dict[str, float]:
    eval_step = step_lib.cached_eval_step(cfg, recipe.task_config, device,
                                          mesh)
    mask_plans = model_lib.precompute_mask_plans(ts.masks)
    # pad_last so validation sets smaller than a batch still evaluate
    # (padded rows are metric-masked in the eval step through `valid`)
    batches = pipeline.BatchIterator(
        val_ds, recipe.batch_size, shuffle=False, drop_last=False,
        pad_last=True)
    total: dict[str, float] = {}
    count = 0

    def _add(m: _HostMetrics) -> None:
        nonlocal count
        for k, v in m.values().items():
            total[k] = total.get(k, 0.0) + v
        count += 1

    # the train loop's one-batch lag: batch N's copy lands behind N+1
    lagged = None
    with pipeline.Prefetcher(batches.epoch(0), device=device) as prefetcher:
        for i, batch in enumerate(prefetcher):
            result = eval_step(ts, batch, mask_plans)
            pending = _HostMetrics(result["metrics"])
            if lagged is not None:
                _add(lagged)
            lagged = pending
            if max_batches is not None and i + 1 >= max_batches:
                break
    if lagged is not None:
        _add(lagged)
    if count == 0:
        raise ValueError("validation produced no batches")
    return {k: v / count for k, v in total.items()}


def _evaluate_task(recipe: Recipe, data_root: str | None, ts,
                   dataset: tuple, **kw) -> dict[str, float]:
    """The task metrics of in-training validation: val_pq and val_ap
    (panoptic), val_ap at the last of `eval_max_queries` (instance), none
    (semantic). The evaluators reuse the loop's cached validation set
    and its eval step."""
    from maskunet_tpu_torch.tasks import evaluators
    if recipe.task == "panoptic":
        pan = evaluators.evaluate_panoptic(recipe, data_root, ts,
                                           dataset=dataset, **kw)
        return {"val_pq": pan["pq"]["All"]["pq"], "val_ap": pan["ap"]["AP"]}
    if recipe.task == "instance":
        q = recipe.eval_max_queries[-1]
        inst = evaluators.evaluate_instances(recipe, data_root, ts,
                                             max_queries=(q,),
                                             dataset=dataset, **kw)
        return {"val_ap": inst[q]["AP"]}
    return {}


def evaluate(recipe: Recipe, data_root: str | None,
             ts: state_lib.TrainState, *, mesh=None, attn_impl: str = "auto",
             compute_dtype: str = "float32",
             max_batches: int | None = None,
             device: str | torch.device = "cuda") -> dict[str, float]:
    """Validation pass: loss + mIoU with running BN stats; under a `mesh`
    each rank evaluates its rows of every batch and the metrics are
    global."""
    _, val_ds, num_classes = make_datasets(recipe, data_root)
    cfg = model_config(recipe, num_classes, attn_impl=attn_impl,
                       compute_dtype=compute_dtype)
    return _evaluate_state(recipe, cfg, ts, val_ds,
                           device=run_device(mesh, device), mesh=mesh,
                           max_batches=max_batches)
