"""Training state: params, BN statistics, optimizer, step, generator, masks.

Counterpart of maskunet_tpu/core/state.py. JAX's state is an immutable
pytree that each step replaces; here the optimizer updates the parameter
tensors in place and the step updates this object's other fields.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict                     # f32 leaf tensors that require grad
    model_state: dict                # BatchNorm running stats
    optimizer: torch.optim.Optimizer
    generator: torch.Generator       # dropout keep masks, 'fresh' masks
    masks: tuple | None = None       # cached per-layer attention key masks


def create(generator: torch.Generator, params: dict, model_state: dict,
           optimizer: Callable[..., torch.optim.Optimizer],
           masks: tuple | None = None) -> TrainState:
    """The state at step 0. `params` are copied to f32 leaves that require
    grad; `optimizer` builds the optimizer over them (e.g.
    `train.loop.make_optimizer(recipe)`), as optax's `tx.init` does."""
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in params.items()}
    return TrainState(step=0, params=params,
                      model_state={k: v.detach().float().clone()
                                   for k, v in model_state.items()},
                      optimizer=optimizer(list(params.values())),
                      generator=generator, masks=masks)
