"""The `train_loop` mix: the port's training step driven as its loop drives
it, and the comparison of its first three steps with the reference.

Set-up builds one TrainState from the seeded weights, masks and
dropout generator, and one step (`train.step.make_train_step`), and
feeds it from a pool of distinct seeded batches cycled through the port's
`data.pipeline.Prefetcher` (pinned host batches, copied on a stream of
its own). The first three steps are the comparison's: their losses, the
first gradient as AdamW holds it after step 1 (exp_avg / (1 - beta1)),
and every parameter's change after step 3 are kept. A few more steps warm
up, then the window runs steps with each step's metrics fetched a step
late and no synchronisation, as the loop does. The rate counts the images
of every step dispatched in the window, over the time until the card has
finished them. The card's clocks and power are sampled through the
window (`harness/card.py`) and printed.

`CONTROLS` are the readings that the comparison's limits are set against
(`tools/readings.py`; the benchmark's runs never make them): the
reference computed in fp8 in the program's place, and the fault of half
the batch left out of the loss.
"""

from __future__ import annotations

import itertools
import math
import time

import torch

from perfbench.harness import card, data, flops, weights

WARM_STEPS = 2       # after the three checked ones
CHECKED_STEPS = 3
CONTROLS = {"control_fp8": {"quant": "fp8"},
            "fault_half_batch": {"half_batch": True}}


def _cycle(pool: dict, batch: int):
    n = pool["image"].shape[0] // batch
    for i in itertools.cycle(range(n)):
        yield {k: v[i * batch:(i + 1) * batch] for k, v in pool.items()}


def _leaf_norms(tensors: dict) -> dict:
    keys = list(tensors)
    norms = torch.stack([tensors[k].float().norm() for k in keys]).tolist()
    return dict(zip(keys, norms))


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        log) -> dict:
    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.data import pipeline
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.ops import flash_kernels as fk
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib

    cfg_file, p = cell["config"], cell["params"]
    img, batch = p["img_size"], p["batch"]
    loss = cfg_file["loss"]
    cfg = mu.MaskAttnUNetConfig(
        c_in=cfg_file["c_in"], c_out=cfg_file["c_out"], img_size=img,
        embed_dim=cfg_file["embed_dim"],
        with_boundary_head=cfg_file["with_boundary_head"],
        dropout_rate=cfg_file["dropout_rate"],
        attn_impl=cfg_file["attn_impl"],
        compute_dtype=cfg_file["compute_dtype"],
        attn_output_layout=cfg_file["attn_output_layout"])
    task = step_lib.TaskConfig(
        ce_weight=loss["ce_weight"], triplet_weight=loss["triplet_weight"],
        triplet_features=("logits" if loss["triplet_features"] == "semantic"
                          else loss["triplet_features"]),
        ignore_index=loss["ignore_index"],
        triplet_ignore_label=loss["triplet_ignore_label"],
        triplet_samples=loss["triplet_samples"], mask_policy="cached")
    params0, mstate = weights.make_weights(cfg_file, img, seed, device)
    masks = weights.make_masks(img, batch, seed, device,
                               cfg_file["attention_key_density"])
    opt = loop_lib.AdamW(cfg_file["optimizer"]["lr"],
                         cfg_file["optimizer"]["weight_decay"])
    gen = torch.Generator(device=device).manual_seed(
        weights.dropout_seed(seed))
    ts = state_lib.create(gen, params0, mstate, opt, masks=masks)
    step = step_lib.make_train_step(
        cfg, task, mask_plans=mu.precompute_mask_plans(ts.masks),
        device=device)
    pool = data.pool(seed, p["pool_batches"] * batch, img_size=img,
                     num_classes=cfg_file["c_out"],
                     num_objects=p["num_objects"],
                     ignore_border=p["ignore_border"])
    if not task.triplet_weight:
        pool.pop("instance")
    feed = pipeline.Prefetcher(_cycle(pool, batch), device=device,
                               depth=p["prefetch_depth"])
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    try:
        # the comparison's steps, through the window's own call and feed
        losses, grad_norms, change_norms = [], None, None
        for i in range(CHECKED_STEPS):
            ts, m = step(ts, next(feed))
            losses.append(float(m["loss"]))
            if i == 0:
                beta1 = ts.optimizer.param_groups[0]["betas"][0]
                # a parameter the optimizer never stepped has no moment
                grad_norms = _leaf_norms({
                    k: ts.optimizer.state[v].get(
                        "exp_avg", torch.zeros_like(v)) / (1 - beta1)
                    for k, v in ts.params.items()})
        change_norms = _leaf_norms({k: ts.params[k].detach() - params0[k]
                                    for k in params0})
        for _ in range(WARM_STEPS):
            ts, m = step(ts, next(feed))
        float(m["loss"])
        sync()
        counters = (fk.flash_fwd_nomax, fk.flash_fwd_nomax_lse, fk.flash_bwd)
        before = [c.launches for c in counters]

        # the window
        clocks = card.Sampler()
        clocks.start()
        t0 = time.perf_counter()
        steps, lagged, window_losses = 0, None, []
        while time.perf_counter() - t0 < seconds:
            ts, m = step(ts, next(feed))
            pending = loop_lib._HostMetrics(m)
            if lagged is not None:
                window_losses.append(lagged.values()["loss"])
            lagged = pending
            steps += 1
        window_losses.append(lagged.values()["loss"])
        sync()
        elapsed = time.perf_counter() - t0
        log(card_in_window=clocks.stop())
        launches = {name: (c.launches - b) / steps for name, c, b in zip(
            ("K1", "K2", "K4"), counters, before)}

        prof = None
        if trace:
            from perfbench.harness import trace as trace_lib

            def stretch():
                nonlocal ts
                lagged = None
                for _ in range(p["profiled_steps"]):
                    with torch.profiler.record_function(trace_lib.SPAN):
                        ts, m = step(ts, next(feed))
                    pending = loop_lib._HostMetrics(m)
                    if lagged is not None:
                        lagged.values()
                    lagged = pending
                sync()

            prof = trace_lib.profile(stretch)
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(device).type == "cuda" else 0)
    finally:
        feed.close()
    del ts, step
    log(launches_per_step=launches)
    failed = sum(1 for v in window_losses if not math.isfinite(v))
    result = {
        "kind": "training", "images": steps * batch, "seconds": elapsed,
        "window_start": t0, "attempted": steps, "failed": failed,
        "memory_peak_bytes": peak, "trace": prof,
        "flops_per_call": flops.model_flops(img, cfg_file, masks)["train"],
        "bounds": flops.attention_bounds(masks),
    }

    def check(**fault) -> dict:
        """The comparison's numbers (`fault`: `compare.train_numbers`'s
        stand-ins for the program's readings)."""
        from perfbench.harness import compare
        first = [{k: v[i * batch:(i + 1) * batch] for k, v in pool.items()}
                 for i in range(CHECKED_STEPS)]
        return compare.train_numbers(
            cfg_file, params0, masks, first, seed, device, losses,
            grad_norms, change_norms, **fault)

    result["check"] = check
    return result
