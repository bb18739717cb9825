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
way; on the card it runs that arithmetic as a hand-written kernel pair
(`ops/batchnorm_kernels.py`).

`conv2d_int8` is JAX's int8 serving conv (the `kernel_q` branch of its
`conv2d`): per-sample dynamic (or static, calibrated) activation scales,
an int8 x int8 -> int32 product by im2col and `torch._int_mm`, and an f32
dequant. `recording_conv_inputs` lets calibration see every float conv's
input, as JAX's calibration monkeypatches its `conv2d`.
"""

from __future__ import annotations

import contextlib
import contextvars
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


# calibration's recorder (`recording_conv_inputs`): None outside it
_CONV_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "conv_recorder", default=None)


@contextlib.contextmanager
def recording_conv_inputs(record):
    """While the block runs, every `conv2d` first calls `record(weight, x)`
    (the counterpart of JAX's calibration monkeypatching its `conv2d`)."""
    token = _CONV_RECORDER.set(record)
    try:
        yield
    finally:
        _CONV_RECORDER.reset(token)


def conv2d(weight: torch.Tensor, bias: torch.Tensor | None,
           x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' conv of NHWC `x` with an OIHW kernel (odd size),
    weights cast to x's dtype."""
    record = _CONV_RECORDER.get()
    if record is not None:
        record(weight, x)
    pad = weight.shape[-1] // 2
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(_nchw(x), weight.to(x.dtype), b, padding=pad)
    return _nhwc(y)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv2d_int8_accumulate(xq: torch.Tensor,
                           kernel_q: torch.Tensor) -> torch.Tensor:
    """The int32 sums of a stride-1 'SAME' conv of NHWC int8 `xq` with an
    OIHW int8 kernel (odd size): im2col by shifted slices of the padded
    input ((kh, kw, C) order along K), then one int8 x int8 -> int32
    `torch._int_mm`, on the CPU and on the card alike. The card's
    `_int_mm` takes K and N in multiples of 8 and more than 16 rows, and
    cuBLASLt refuses some shapes that meet that (N = 152 at 131,072 rows
    and K = 64: the ADE head, c_out 150, at batch 8), so K is padded with
    zeros to a multiple of 8 (the first conv has K = 27), the output
    channels to a multiple of 32 (150 -> 160, which it takes) and the
    rows to at least 32; zeros add nothing, so the sums are exact.
    Returns [B, H, W, O] int32."""
    b, h, w, c = xq.shape
    o, _, kh, kw = kernel_q.shape
    if kh == kw == 1:
        cols = xq.reshape(b * h * w, c)
    else:
        xp = F.pad(xq, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
        cols = torch.cat([xp[:, i:i + h, j:j + w] for i in range(kh)
                          for j in range(kw)], dim=-1)
        cols = cols.reshape(b * h * w, kh * kw * c)
    m, k = cols.shape
    kp, op, mp = _round_up(k, 8), _round_up(o, 32), max(m, 32)
    cols = F.pad(cols, (0, kp - k, 0, mp - m))
    wmat = F.pad(kernel_q.permute(0, 2, 3, 1).reshape(o, k),
                 (0, kp - k, 0, op - o))
    # B as the transpose of a row-major [N, K]: the int8 GEMM's TN layout
    acc = torch._int_mm(cols, wmat.t())
    return acc[:m, :o].reshape(b, h, w, o)


def div_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 by a true division on every device: the card divides by a
    Python scalar through its reciprocal, which rounds otherwise than the
    CPU's division (and XLA's) in the last bit."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def conv2d_int8(kernel_q: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None, x: torch.Tensor,
                a_scale: torch.Tensor | None = None) -> torch.Tensor:
    """JAX's int8 serving conv (maskunet_tpu/core/layers.py:62-87): `x`
    quantized with a per-sample scale a = max(max|x| over H, W, C / 127,
    1e-12) (per sample, not per batch, so an image's prediction does not
    depend on its batch-mates) or the static calibrated `a_scale`, as
    clip(round(x / a), -127, 127) (round half to even, as `jnp.round`);
    the int32 conv sums (`conv2d_int8_accumulate`) dequantized in f32 as
    acc * (a * w_scale[c]), plus the bias in f32, cast to x's dtype. Never
    a float conv."""
    xf = x.float()
    if a_scale is None:
        a = torch.clamp(div_127(xf.abs().amax(dim=(1, 2, 3), keepdim=True)),
                        min=1e-12)
    else:
        a = a_scale
    xq = torch.clamp(torch.round(xf / a), -127, 127).to(torch.int8)
    y = conv2d_int8_accumulate(xq, kernel_q).float() * (a * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


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
                    eps: float = 1e-5, group=None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm over (N, H, W) per channel, torch semantics, as
    JAX's `batchnorm(train=True)`: normalise with the biased batch variance
    E[x^2] - mean^2 in f32, fold the unbiased variance into the running
    stats with momentum 0.1. Returns (y in x's dtype, new running mean, new
    running var); the running stats carry no gradient.

    `group`: the data axis's process group (cross-replica BatchNorm, as
    GSPMD gives JAX's DP): the per-channel Σx and Σx², summed in f32, and
    the count go through one all-reduce, gradients flowing through it, so
    the statistics are the global batch's on every rank (the count rides
    in f32: exact up to 2^24 pixels a call).

    A CUDA tensor without `group` runs the hand-written kernel pair
    (`ops/batchnorm_kernels.BatchNormTrain`: two passes forward, two
    backward, the same arithmetic; bf16 or f32 x and f32 parameters, or it
    raises), counted in `batchnorm_train.fused`. Every other call runs the
    plain ops (`batchnorm_train_plain`); those on the card, the
    cross-replica ones, are counted in `batchnorm_train.plain_cuda`.
    """
    if x.device.type == "cuda":
        if group is None:
            from maskunet_tpu_torch.ops import batchnorm_kernels as bk
            out = bk.BatchNormTrain.apply(x, weight, bias, running_mean,
                                          running_var, momentum, eps)
            batchnorm_train.fused += 1
            return out
        batchnorm_train.plain_cuda += 1
    return batchnorm_train_plain(weight, bias, running_mean, running_var, x,
                                 momentum=momentum, eps=eps, group=group)


batchnorm_train.fused = 0
batchnorm_train.plain_cuda = 0


def batchnorm_train_plain(weight: torch.Tensor, bias: torch.Tensor,
                          running_mean: torch.Tensor,
                          running_var: torch.Tensor, x: torch.Tensor, *,
                          momentum: float = 0.1, eps: float = 1e-5,
                          group=None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`batchnorm_train` in plain ops, on any device: what every CPU call
    and every cross-replica call runs."""
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    if group is None:
        mean = xf.mean(dim=dims)
        var = xf.square().mean(dim=dims) - mean.square()
        bessel = n / max(n - 1, 1)
    else:
        from maskunet_tpu_torch.parallel import mesh as mesh_lib
        c = x.shape[-1]
        sums = mesh_lib.all_reduce_sum(torch.cat([
            xf.sum(dim=dims), xf.square().sum(dim=dims),
            xf.new_full((1,), float(n))]), group)
        count = sums[2 * c].detach()
        mean = sums[:c] / count
        var = sums[c:2 * c] / count - mean.square()
        bessel = count / torch.clamp(count - 1, min=1)
    with torch.no_grad():
        unbiased = var * bessel
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
