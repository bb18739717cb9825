"""Train-mode BatchNorm as a hand-written CUDA kernel pair: its source's
build, its wrappers, their plain PyTorch versions and the autograd
Function around them.

`core/layers.batchnorm_train` sends every CUDA call without a
cross-replica group here. The forward and the backward are two passes
each over a contiguous NHWC activation (`BatchNormTrain` makes x
contiguous), in f32, with JAX's arithmetic (var = E[x^2] - mean^2); see
`csrc/batchnorm_train.cu`. The source is one of `flash_kernels.SOURCES`,
built with the flash kernels' (nvcc for sm_90a into
`maskunet_tpu_torch/_build/`, a plain C entry point loaded with ctypes)
at the first launch, and each launch runs on the current CUDA stream,
with no host synchronisation and no allocation of its own: the wrapper
allocates every output and the partial sums' workspace with the torch
allocator.

A CPU tensor goes to the wrapper's plain version (`*_reference`, the
kernel's arithmetic in plain PyTorch, in f64 for f64 inputs); a CUDA
tensor always launches the kernels, or raises on what they do not take
(`check`: x other than bf16 or f32, parameters other than f32 [C]). Each
wrapper counts its kernel launches in `<wrapper>.launches` (three a call:
a reduction, the finishing of its sums, an elementwise pass).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskunet_tpu_torch.ops import flash_kernels as fk

THREADS = 256        # `kThreads` of the source: threads a block of a pass
MIN_ROWS = 8         # rows a thread walks at least
BLOCK_THREADS = 1024  # threads an SM the passes' blocks aim at

_ptr, _int, _ll, _float = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
_ENTRIES = {
    "bn_train_forward": [_ptr, _int, _int, _ll] + [_int] * 4 + [_ptr] * 4
                        + [_float] * 5 + [_ptr] * 6,
    "bn_train_backward": [_ptr, _ptr, _int, _int, _ll] + [_int] * 4
                         + [_ptr] * 2 + [_float] + [_ptr] * 6,
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point `name`, from the library (built on first use,
    with the flash kernels' libraries in one round of parallel nvcc
    processes: a train step's first BatchNorm comes before its first
    attention)."""
    lib = fk.build()["batchnorm_train"]["path"]
    fn = getattr(ctypes.CDLL(lib), name)
    fn.argtypes = _ENTRIES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = _entry(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def geometry(m: int, c: int, vec: int, sms: int) -> tuple[int, int, int]:
    """(blocks along the rows, channel groups a block, rows a block at
    once) of the row passes for m rows of c channels read `vec` channels
    a thread: a block of at most THREADS threads covers min(groups,
    THREADS) groups; enough blocks to hold ~BLOCK_THREADS threads on each
    of `sms` SMs, but at least MIN_ROWS rows a thread."""
    groups = c // vec
    gt = min(groups, THREADS)
    rows = THREADS // gt
    gy = -(-groups // gt)
    per_sm = max(1, BLOCK_THREADS // (gt * rows))
    nb = max(1, min(-(-m // (rows * MIN_ROWS)), per_sm * sms // gy))
    return nb, gt, rows


def _vector_width(x: torch.Tensor, *others: torch.Tensor) -> int:
    """Channels a thread loads at once: 16 bytes where C divides into them
    and every row tensor starts on a 16-byte boundary, else 1."""
    v = 16 // x.element_size()
    ok = x.shape[-1] % v == 0 and all(t.data_ptr() % 16 == 0
                                      for t in (x, *others))
    return v if ok else 1


def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def forward_reference(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor,
                      running_var: torch.Tensor, momentum: float, eps: float
                      ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernels: (y in x's dtype,
    stats [3, C] = mean, rstd, rstd * weight, new running mean, new
    running var), in f32 (f64 for f64 x)."""
    xf = x.to(_acc(x))
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    mean = xf.mean(dim=dims)
    var = xf.square().mean(dim=dims) - mean.square()
    rstd = torch.rsqrt(var + eps)
    scale = rstd * weight
    y = ((xf - mean) * scale + bias).to(x.dtype)
    new_mean = (1 - momentum) * running_mean + momentum * mean
    new_var = (1 - momentum) * running_var + momentum * (
        var * (n / max(n - 1, 1)))
    return y, torch.stack([mean, rstd, scale]), new_mean, new_var


def backward_reference(x: torch.Tensor, dy: torch.Tensor,
                       weight: torch.Tensor, stats: torch.Tensor
                       ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernels: (dx in x's dtype,
    dweight, dbias) from the forward's `stats`, as the kernels compute
    them: dbias = sum(dy), dweight = rstd * sum(dy (x - mean)), dx =
    weight rstd ((dy - sum(dy) / n) - (x - mean) rstd^2 sum(dy (x - mean))
    / n)."""
    xf, dyf = x.to(_acc(x)), dy.to(_acc(x))
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    mean, rstd = stats[0], stats[1]
    xc = xf - mean
    sdy = dyf.sum(dim=dims)
    sdyxc = (dyf * xc).sum(dim=dims)
    a = weight * rstd
    k = rstd * rstd * sdyxc / n
    dx = a * ((dyf - sdy / n) - xc * k)
    return dx.to(x.dtype), sdyxc * rstd, sdy


def bn_train_forward(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float, eps: float
                     ) -> tuple[torch.Tensor, ...]:
    """The forward: (y, stats, new running mean, new running var), as
    `forward_reference` returns them. CPU tensors run the plain version;
    CUDA tensors launch the kernels (x and the parameters contiguous, as
    `check` admits them); any other device raises."""
    if not fk._on_card(x):
        return forward_reference(x, weight, bias, running_mean, running_var,
                                 momentum, eps)
    check(x, weight, bias, running_mean, running_var)
    c = x.shape[-1]
    m = x.numel() // c
    vec = _vector_width(x)
    nb, gt, rows = geometry(m, c, vec, _sm_count(x.device.index or 0))
    y = torch.empty_like(x)
    part = torch.empty(2 * nb * c, device=x.device)
    stats = torch.empty(3, c, device=x.device)
    new_mean = torch.empty_like(running_mean)
    new_var = torch.empty_like(running_var)
    _launch("bn_train_forward", x.device, x.data_ptr(),
            int(x.dtype == torch.bfloat16), int(vec > 1), m, c, nb, gt, rows,
            weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), 1 - momentum, momentum,
            m / max(m - 1, 1), eps, 1.0 / m, y.data_ptr(), part.data_ptr(),
            stats.data_ptr(), new_mean.data_ptr(), new_var.data_ptr())
    bn_train_forward.launches += 3
    return y, stats, new_mean, new_var


bn_train_forward.launches = 0


def bn_train_backward(x: torch.Tensor, dy: torch.Tensor,
                      weight: torch.Tensor, stats: torch.Tensor
                      ) -> tuple[torch.Tensor, ...]:
    """The backward: (dx, dweight, dbias), as `backward_reference` returns
    them. CPU tensors run the plain version; CUDA tensors launch the
    kernels (dy made contiguous first)."""
    if not fk._on_card(x):
        return backward_reference(x, dy, weight, stats)
    check(x, weight, stats[0], stats[1], stats[2])
    dy = dy.contiguous()
    c = x.shape[-1]
    m = x.numel() // c
    vec = _vector_width(x, dy)
    nb, gt, rows = geometry(m, c, vec, _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    part = torch.empty(2 * nb * c + 3 * c, device=x.device)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    _launch("bn_train_backward", x.device, x.data_ptr(), dy.data_ptr(),
            int(x.dtype == torch.bfloat16), int(vec > 1), m, c, nb, gt, rows,
            weight.data_ptr(), stats.data_ptr(), 1.0 / m, part.data_ptr(),
            part.data_ptr() + 2 * nb * c * 4, dx.data_ptr(), dw.data_ptr(),
            db.data_ptr())
    bn_train_backward.launches += 3
    return dx, dw, db


bn_train_backward.launches = 0


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm with the kernels' forward and backward: apply
    (x, weight, bias, running_mean, running_var, momentum, eps) -> (y,
    new running mean, new running var); the running stats carry no
    gradient. x and the parameters are made contiguous (a copy only where
    they are not). Saves x (not an f32 copy), weight and the [3, C]
    stats."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        x, weight, bias, running_mean, running_var = (
            t.contiguous() for t in (x, weight, bias, running_mean,
                                     running_var))
        y, stats, new_mean, new_var = bn_train_forward(
            x, weight, bias, running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, stats)
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, stats = ctx.saved_tensors
        dx, dw, db = bn_train_backward(x, dy, weight, stats)
        return dx, dw, db, None, None, None, None


def check(x: torch.Tensor, *params: torch.Tensor) -> None:
    """Raise ValueError unless the kernels take these tensors: a
    contiguous bf16 or f32 x of at least one row and one channel
    (channels last), and contiguous f32 [C] parameters on x's device."""
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() < 2 \
            or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(
            f"the train BatchNorm kernels take a contiguous bf16 or f32 "
            f"[..., C] x, not {x.dtype} {tuple(x.shape)} strides "
            f"{x.stride()}")
    c = x.shape[-1]
    for t in params:
        if t.dtype != torch.float32 or t.shape != (c,) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(
                f"the train BatchNorm kernels take contiguous f32 [{c}] "
                f"parameters on {x.device}, not {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
