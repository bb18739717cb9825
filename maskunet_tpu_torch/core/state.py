"""Training state: params, BN statistics, optimizer, step, generator, masks.

Counterpart of maskunet_tpu/core/state.py. JAX's state is an immutable
pytree that each step replaces; here the optimizer updates the parameter
tensors in place and the step updates this object's other fields. An lr
schedule (optax's state carries its count) is the `scheduler` beside the
optimizer.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict                     # f32 leaf tensors that require grad
    model_state: dict                # BatchNorm running stats
    optimizer: torch.optim.Optimizer
    generator: torch.Generator       # dropout keep masks, 'fresh' masks
    masks: tuple | None = None       # cached per-layer attention key masks
    scheduler: torch.optim.lr_scheduler.LambdaLR | None = None


def create(generator: torch.Generator, params: dict, model_state: dict,
           optimizer, masks: tuple | None = None) -> TrainState:
    """The state at step 0. `params` are copied to f32 leaves that require
    grad; `optimizer` (`train.loop.make_optimizer(recipe)`) builds the
    optimizer over them, and its lr scheduler if it has a schedule, as
    optax's `tx.init` does."""
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = optimizer(list(params.values()))
    return TrainState(step=0, params=params,
                      model_state={k: v.detach().float().clone()
                                   for k, v in model_state.items()},
                      optimizer=opt, generator=generator, masks=masks,
                      scheduler=optimizer.scheduler(opt))
