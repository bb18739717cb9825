"""Layers of the forward as plain functions on tensors.

Counterpart of maskunet_tpu/core/layers.py. Feature maps are NHWC at every
public function, as in the JAX package; a convolution runs on the NCHW view
of the same memory (channels_last strides), so no copy is made around it.
Weights keep PyTorch's own layouts: conv OIHW, linear [out, in].

Numerics follow the JAX layers: BatchNorm and LayerNorm compute in f32 and
cast back; GELU is exact erf in f32 and the tanh form in bf16; the bilinear
upsample is two interpolation matmuls in the compute dtype, rounded to it
between the two. Where JAX multiplies a bf16 array by a Python float, the
float is first rounded to bf16 (weak typing): `weak_scalar` reproduces that.

Train-mode BatchNorm follows JAX's arithmetic (f32, var = E[x^2] - mean^2)
in plain ops rather than `F.batch_norm`, whose variance is computed another
way. The int8 conv belongs to a later slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def weak_scalar(x: float, dtype: torch.dtype) -> float:
    """`x` as JAX applies a Python scalar to an array of `dtype`: rounded
    to that dtype first (torch keeps the scalar in f32 instead)."""
    return float(torch.tensor(x, dtype=dtype))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(weight: torch.Tensor, bias: torch.Tensor | None,
           x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' conv of NHWC `x` with an OIHW kernel (odd size),
    weights cast to x's dtype."""
    pad = weight.shape[-1] // 2
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(_nchw(x), weight.to(x.dtype), b, padding=pad)
    return _nhwc(y)


def linear(weight: torch.Tensor, bias: torch.Tensor | None,
           x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ weight[out, in]^T + bias, in x's dtype."""
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, weight.to(x.dtype), b)


def batchnorm(weight: torch.Tensor, bias: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor, x: torch.Tensor,
              *, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm over the last (channel) axis, in f32."""
    inv = torch.rsqrt(var + eps) * weight
    return ((x.float() - mean) * inv + bias).to(x.dtype)


def batchnorm_train(weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    x: torch.Tensor, *, momentum: float = 0.1,
                    eps: float = 1e-5
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm over (N, H, W) per channel, torch semantics, as
    JAX's `batchnorm(train=True)`: normalise with the biased batch variance
    E[x^2] - mean^2 in f32, fold the unbiased variance into the running
    stats with momentum 0.1. Returns (y in x's dtype, new running mean, new
    running var); the running stats carry no gradient."""
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=dims)
    var = xf.square().mean(dim=dims) - mean.square()
    n = x.numel() // x.shape[-1]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    inv = torch.rsqrt(var + eps) * weight
    return ((xf - mean) * inv + bias).to(x.dtype), new_mean, new_var


def layernorm(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axes that `weight` covers, in f32:
    (C,) for the attention norm, (H, W, C) for the model's joint final norm
    (pass that one's [C, H, W] parameters permuted to [H, W, C])."""
    dims = tuple(range(x.dim() - weight.dim(), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in f32; the tanh form in bf16 (its deviation is below
    bf16's rounding step), as the JAX layer does."""
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x, approximate=approx)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=2, stride=2) on NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), 2))


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True bilinear interpolation matrix."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (src - lo).astype(np.float32)
    m[np.arange(n_out), lo] += 1.0 - w
    m[np.arange(n_out), hi] += w
    return m


def upsample_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Upsample(scale 2, bilinear, align_corners=True) on NHWC as two
    interpolation matmuls in x's dtype (f32 accumulation, rounded to the
    dtype after each)."""
    _, h, w, _ = x.shape
    mh = torch.from_numpy(_interp_matrix_np(h, 2 * h)).to(x.device, x.dtype)
    mw = torch.from_numpy(_interp_matrix_np(w, 2 * w)).to(x.device, x.dtype)
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)


def dropout(x: torch.Tensor, *, rate: float,
            generator: torch.Generator | None, train: bool,
            keep_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout, `where(keep, x / (1 - rate), 0)` in x's dtype, with
    1 - rate rounded to that dtype first (JAX weak typing: 0.69921875 for
    rate 0.3 in bf16). `keep_mask` (True = keep) replaces the draw from
    `generator`."""
    if not train or rate == 0.0:
        return x
    keep = (dropout_keep_mask(generator, rate, x.shape) if keep_mask is None
            else keep_mask)
    return torch.where(keep, x / weak_scalar(1.0 - rate, x.dtype), 0)


def dropout_keep_mask(generator: torch.Generator, rate: float,
                      shape) -> torch.Tensor:
    """Boolean keep mask for `dropout` (True = keep, probability 1 - rate),
    drawn on `generator`'s device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) >= rate
