"""The `training` loop: a model's training step driven as the port's loop
drives it, and the comparison of its first three steps with the plain
reference.

Everything of the model comes from its module, `models/<module>.py`
(`spec.model`), as a `Built`: the port's train state and step, made from
seeded weights at set-up, the seeded initial parameters, the launch
counters, the FLOPs a call and the attention bounds, and the reference's
checked steps. This loop feeds the step from a pool of distinct seeded
batches (`harness/data.py`, the keys the step takes) cycled through the
port's `data.pipeline.Prefetcher` (pinned host batches, copied on a stream
of its own). The first three steps are the comparison's: their losses,
the first gradient as AdamW holds it after step 1 (exp_avg / (1 -
beta1)), and every parameter's change after step 3 are kept. A few more
steps warm up, then the window runs steps with each step's metrics
fetched a step late and no synchronisation, as the loop does. The rate
counts the images of every step dispatched in the window, over the time
until the card has finished them. The card's clocks and power are sampled
through the window (`harness/card.py`) and printed.

`CONTROLS` are the readings that the comparison's limits are set against
(`tools/readings.py`; the benchmark's runs never make them): the
reference computed in fp8 in the program's place, and the fault of half
the batch left out of the loss. A model's reference takes both.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable

import torch

from perfbench.harness import card, data, spec

WARM_STEPS = 2       # after the three checked ones
CHECKED_STEPS = 3
CONTROLS = {"control_fp8": {"quant": "fp8"},
            "fault_half_batch": {"half_batch": True}}


@dataclasses.dataclass
class Built:
    """What a model's module builds for this loop.

    `state`: the port's train state, with `params` (name -> leaf) and
    `optimizer` (a torch optimizer that keeps Adam's `exp_avg`); `step(state,
    batch) -> (state, metrics)`, `metrics["loss"]` a tensor; `params0`: the
    seeded initial parameters, under the reference's names; `classes`: the
    labels the pool draws from; `pool_keys`: the pool's keys that the step
    takes; `flops_per_call`: the model's FLOPs of one step; `bounds`: the
    attention kernels' least seconds a step (`{'fwd', 'bwd'}`, or `{}`);
    `counters`: name -> an object whose `launches` counts a kernel's
    launches; `reference(batches, *, quant=None, half_batch=False)`: the
    plain reference's steps from `params0` over these device batches
    (image f32 in [0, 1]), returning (losses, first gradients, the
    parameters after the last step).
    """

    state: object
    step: Callable
    params0: dict
    classes: int
    pool_keys: tuple
    flops_per_call: float
    bounds: dict
    counters: dict
    reference: Callable


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
    from maskunet_tpu_torch.data import pipeline
    from maskunet_tpu_torch.train import loop as loop_lib

    p = cell["params"]
    img, batch = p["img_size"], p["batch"]
    built = spec.model(cell["config"]).training(cell, seed, device)
    pool = data.pool(seed, p["pool_batches"] * batch, img_size=img,
                     num_classes=built.classes,
                     num_objects=p["num_objects"],
                     ignore_border=p["ignore_border"])
    pool = {k: v for k, v in pool.items() if k in built.pool_keys}
    # the loop alone holds the state, as the port's loop does
    ts, step, params0 = built.state, built.step, built.params0
    counters, reference = built.counters, built.reference
    flops_per_call, bounds = built.flops_per_call, built.bounds
    del built
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
        before = {k: c.launches for k, c in counters.items()}

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
        launches = {k: (c.launches - before[k]) / steps
                    for k, c in counters.items()}

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
        "flops_per_call": flops_per_call, "bounds": bounds,
    }

    def check(**fault) -> dict:
        """The comparison's numbers (`fault`: `compare.train_numbers`'s
        stand-ins for the program's readings)."""
        from perfbench.harness import compare
        first = [{k: v[i * batch:(i + 1) * batch] for k, v in pool.items()}
                 for i in range(CHECKED_STEPS)]
        return compare.train_numbers(
            reference, params0, first, device, losses, grad_norms,
            change_norms, **fault)

    result["check"] = check
    return result
