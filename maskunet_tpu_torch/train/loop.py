"""Training set-up: the model config, the optimizer, the initial state.

Counterpart of the set-up half of maskunet_tpu/train/loop.py (`:52-101`).
The loop itself (epochs, checkpoints, early stop, datasets, evaluation)
waits for the checkpoint and datasets slice.
"""

from __future__ import annotations

import functools

import torch

from maskunet_tpu_torch.core import state as state_lib
from maskunet_tpu_torch.core.device import resolve_device
from maskunet_tpu_torch.models import maskattn_unet as model_lib
from maskunet_tpu_torch.tasks.recipes import Recipe


def make_optimizer(recipe: Recipe, *, lr_schedule: str | None = None):
    """AdamW at the recipe's constant lr, as a factory over the parameters
    (`state_lib.create` calls it). Matches `optax.adamw(lr,
    weight_decay=recipe.weight_decay)` term for term: betas (0.9, 0.999),
    eps 1e-8 outside the square root, decoupled decay on every parameter.
    The decay is passed explicitly: torch's default is 0.01, optax's
    1e-4. The optimizer lives on its parameters' device."""
    if lr_schedule is not None:
        raise NotImplementedError("lr_schedule: training-loop slice")
    return functools.partial(torch.optim.AdamW, lr=recipe.lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=recipe.weight_decay)


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
