"""The toy model's plain reference: its convs as unfolded matmuls over
NHWC pixels, the reference's cross-entropy and written-out AdamW
(`reference/train.py`); `quant="fp8"` rounds every operand to fp8."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.model import fp8_round
from perfbench.reference.train import AdamW, cross_entropy


def init(cfg: dict, seed: int, device) -> dict:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from one generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = [cfg["c_in"], *cfg["widths"]]
    shapes = {"conv1": (w[1], w[0], 3, 3), "conv2": (w[2], w[1], 3, 3),
              "head": (cfg["c_out"], w[2], 1, 1)}
    params = {}
    for name, shape in shapes.items():
        bound = (shape[1] * shape[2] * shape[3]) ** -0.5
        for part, size in (("weight", shape), ("bias", shape[:1])):
            u = torch.rand(size, generator=gen, device=device)
            params[f"{name}.{part}"] = (2 * u - 1) * bound
    return params


def _conv(x, w, b, q):
    """x [B, H, W, C] -> [B, H, W, O]; w [O, C, k, k], 'same' padding."""
    n, h, wd, _ = x.shape
    k = w.shape[-1]
    cols = F.unfold(q(x).permute(0, 3, 1, 2), k, padding=k // 2)
    out = q(w).reshape(w.shape[0], -1) @ cols + b[:, None]
    return out.reshape(n, -1, h, wd).permute(0, 2, 3, 1)


def forward(params, image, quant=None):
    q = fp8_round if quant == "fp8" else (lambda t: t)
    x = torch.relu(_conv(image, params["conv1.weight"],
                         params["conv1.bias"], q))
    x = torch.relu(_conv(x, params["conv2.weight"], params["conv2.bias"], q))
    return _conv(x, params["head.weight"], params["head.bias"], q)


def train_steps(params0: dict, batches, cfg: dict, quant=None,
                half_batch=False):
    """(losses, first gradients, parameters after the last step)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = AdamW(params, cfg["optimizer"]["lr"],
                cfg["optimizer"]["weight_decay"])
    losses, first = [], None
    for b in batches:
        rows = slice(0, b["image"].shape[0] // 2 if half_batch else None)
        loss = cross_entropy(forward(params, b["image"][rows], quant),
                             b["label"][rows])
        keys = list(params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [params[k] for k in keys])))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}
