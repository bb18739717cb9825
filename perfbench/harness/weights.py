"""Weights, masks and the generators' seeds, made from `--seed` on the device.

Every tensor comes from one generator on the device, in two large draws:
all the conv and linear tensors from one uniform draw (torch's default
init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))), and all the norm affines and
running statistics from a second. The affines and running statistics are
drawn away from the identity (weight in [0.5, 1.5], bias and running
mean in [-0.2, 0.2], running variance in [0.5, 2]), so that folding each
BatchNorm into its conv changes the numbers and the comparison sees it.
Then one Bernoulli key mask a row and attention layer, each key visible
with the configuration's `attention_key_density`.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.model import attention_lengths, param_specs

_RANGES = {"norm_w": (0.5, 1.5), "norm_b": (-0.2, 0.2),
           "mean": (-0.2, 0.2), "var": (0.5, 2.0)}


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for `stream` of the run's `seed`."""
    state = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31 | int(state[1]) >> 1) % 2 ** 63


def make_weights(cfg: dict, img_size: int, seed: int, device
                 ) -> tuple[dict, dict]:
    """(params, running stats) under the reference's names, f32 on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 0))
    specs = param_specs(cfg["c_out"], cfg["embed_dim"],
                        cfg["with_boundary_head"], img_size)
    dense = [s for s in specs if s[2] in ("w", "b")]
    norms = [s for s in specs if s[2] not in ("w", "b")]
    params, state = {}, {}
    for group in (dense, norms):
        sizes = [int(np.prod(shape)) for _, shape, _, _ in group]
        flat = torch.rand(sum(sizes), generator=gen, device=device)
        for (name, shape, kind, fan_in), part in zip(
                group, torch.split(flat, sizes)):
            if kind in ("w", "b"):
                lo, hi = -fan_in ** -0.5, fan_in ** -0.5
            else:
                lo, hi = _RANGES[kind]
            t = (part * (hi - lo) + lo).reshape(shape)
            (state if kind in ("mean", "var") else params)[name] = t
    return params, state


def make_masks(img_size: int, rows: int, seed: int, device,
               density: float) -> tuple[torch.Tensor, ...]:
    """Six [rows, L] bool key masks, each key visible with probability
    `density`."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    return tuple(torch.rand((rows, n), generator=gen, device=device)
                 < density for n in attention_lengths(img_size))


def dropout_seed(seed: int) -> int:
    """The seed of the generator that the step draws dropout and triplets
    from; the reference seeds its own with it."""
    return derived_seed(seed, 2)
