"""MaskAttn-UNet as the reference scripts define it, in plain PyTorch.

The topology of the reference's modules (github.com/Belis0811/MaskUnet,
code/ade20k/ade_semantic.py and code/cityscapes/city_instance.py): a
U-Net of ConvBlocks (conv-BN-GELU-conv-BN, a residual block ending in
GELU(x + h)), three Down and three Up stages each ending in a BatchNorm,
six single-head masked self-attention blocks (attn1-3 after the Down
stages, attn4-6 after the Up stages) whose output is LayerNorm(attn +
tokens), a joint LayerNorm over [64, H, W], and 1x1 heads with BatchNorm
and ReLU on the logits. Parameters are a flat dict under the reference's
state_dict names. Everything runs in f32 with TF32 off; the attention is
computed in blocks of queries (`_BlockAttention`) so that 65,536 tokens
fit, with its backward written out.

Departures from the scripts, each also the program's: the attention
output is un-flattened as the inverse of the flatten (the recipes'
'transpose' layout) and the dropout keep masks are drawn in NHWC order,
so that one generator gives both sides the same masks.

`quant="fp8"` is the control: computed in fp8 where the program computes
in bf16. Every operand of a convolution, a linear layer and the two
attention products, and every activation the program keeps in bf16 (the
outputs of the convs, the BatchNorms, GELU, the residual sums, the
upsample, the attention block, the LayerNorm, the heads), is rounded to
float8_e4m3fn (one scale a tensor, its max at 448) before the f32
arithmetic goes on. Gradients pass the rounding straight through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ATTN_CHANNELS = (128, 256, 256, 128, 64, 64)
ATTN_SCALES = (2, 4, 8, 4, 2, 1)
_DOWN = ((64, 128), (128, 256), (256, 256))
_BOTTOM = ((256, 512), (512, 512), (512, 256))
_UP = ((512, 128), (256, 64), (128, 64))
EPS = 1e-5
FP8_MAX = 448.0


def attention_lengths(img_size: int) -> tuple[int, ...]:
    return tuple((img_size // s) ** 2 for s in ATTN_SCALES)


def _blocks():
    """(prefix, cin, mid, cout) of every ConvBlock."""
    out = [("initial_conv.conv_block", 3, 64, 64)]
    for i in (1, 2, 3):
        dc, do = _DOWN[i - 1]
        bc, bo = _BOTTOM[i - 1]
        uc, uo = _UP[i - 1]
        out += [(f"downsample{i}.maxpool_conv.1.conv_block", dc, dc, dc),
                (f"downsample{i}.maxpool_conv.2.conv_block", dc, do, do),
                (f"bottom{i}.conv_block", bc, bo, bo),
                (f"upsample{i}.conv.0.conv_block", uc, uc, uc),
                (f"upsample{i}.conv.1.conv_block", uc, uc // 2, uo)]
    return out


def param_specs(c_out: int, embed_dim: int, with_boundary_head: bool,
                img_size: int) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every tensor of the model, kind in
    'w' (conv or linear weight), 'b' (their bias), 'norm_w', 'norm_b'
    (BatchNorm and LayerNorm affines), 'mean', 'var' (running stats)."""
    specs = []

    def conv(name, cin, cout, k, bias):
        specs.append((f"{name}.weight", (cout, cin, k, k), "w", cin * k * k))
        if bias:
            specs.append((f"{name}.bias", (cout,), "b", cin * k * k))

    def bn(name, c):
        specs.extend([(f"{name}.weight", (c,), "norm_w", 0),
                      (f"{name}.bias", (c,), "norm_b", 0),
                      (f"{name}.running_mean", (c,), "mean", 0),
                      (f"{name}.running_var", (c,), "var", 0)])

    for prefix, cin, mid, cout in _blocks():
        conv(f"{prefix}.0", cin, mid, 3, False)
        bn(f"{prefix}.1", mid)
        conv(f"{prefix}.3", mid, cout, 3, False)
        bn(f"{prefix}.4", cout)
    for i, (_, c) in enumerate(_DOWN, 1):
        bn(f"downsample{i}.maxpool_conv.3", c)
    for i, (_, c) in enumerate(_UP, 1):
        bn(f"upsample{i}.conv.2", c)
    for i, c in enumerate(ATTN_CHANNELS, 1):
        for lin in ("query", "key", "value"):
            specs.append((f"self_attention{i}.{lin}.weight", (c, c), "w", c))
            specs.append((f"self_attention{i}.{lin}.bias", (c,), "b", c))
        specs.append((f"self_attention{i}.norm.weight", (c,), "norm_w", 0))
        specs.append((f"self_attention{i}.norm.bias", (c,), "norm_b", 0))
    specs.append(("norm.weight", (64, img_size, img_size), "norm_w", 0))
    specs.append(("norm.bias", (64, img_size, img_size), "norm_b", 0))
    conv("final_layer.0", 64, c_out, 1, True)
    bn("final_layer.1", c_out)
    if embed_dim > 0:
        conv("embedding_head.0", 64, embed_dim, 1, True)
        bn("embedding_head.1", embed_dim)
    if with_boundary_head:
        conv("boundary_head.0", c_out, 32, 3, True)
        bn("boundary_head.1", 32)
        conv("boundary_head.3", 32, 1, 1, True)
    return specs


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8_e4m3fn under one scale (its max at 448), back
    in t's dtype; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


class _BlockAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(C) over the visible keys) v for one image,
    queries in blocks; a query that sees no key gives zeros. The backward
    recomputes each block's probabilities."""

    BLOCK = 4096

    @staticmethod
    def forward(ctx, q, k, v, mask):
        scale = 1.0 / math.sqrt(q.shape[-1])
        out = torch.empty_like(q)
        for s in range(0, q.shape[0], _BlockAttention.BLOCK):
            p = _probs(q[s:s + _BlockAttention.BLOCK], k, mask, scale)
            out[s:s + _BlockAttention.BLOCK] = p @ v
        ctx.save_for_backward(q, k, v, mask, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out = ctx.saved_tensors
        scale = 1.0 / math.sqrt(q.shape[-1])
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        for s in range(0, q.shape[0], _BlockAttention.BLOCK):
            e = s + _BlockAttention.BLOCK
            p = _probs(q[s:e], k, mask, scale)
            dv += p.t() @ dout[s:e]
            dp = dout[s:e] @ v.t()
            ds = p * (dp - (dout[s:e] * out[s:e]).sum(-1, keepdim=True))
            dq[s:e] = ds @ k * scale
            dk += ds.t() @ q[s:e] * scale
        return dq, dk, dv, None


def _probs(q, k, mask, scale):
    scores = (q @ k.t()) * scale
    scores = scores.masked_fill(~mask[None, :], float("-inf"))
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    return e / e.sum(-1, keepdim=True).clamp(min=1e-30)


class Reference:
    """The model over `params` (and, for eval BatchNorm, `state`)."""

    def __init__(self, params: dict, state: dict | None, *, c_out: int,
                 embed_dim: int = 0, with_boundary_head: bool = False,
                 dropout_rate: float = 0.3, quant: str | None = None):
        self.p, self.s = params, state
        self.c_out, self.embed_dim = c_out, embed_dim
        self.with_boundary_head = with_boundary_head
        self.rate = dropout_rate
        self.quant = quant

    def _q(self, t):
        return fp8_round(t) if self.quant == "fp8" else t

    def conv(self, name, x):
        w = self.p[f"{name}.weight"]
        return self._q(F.conv2d(self._q(x), self._q(w),
                                self.p.get(f"{name}.bias"),
                                padding=w.shape[-1] // 2))

    def bn(self, name, x, train):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean = self.s[f"{name}.running_mean"]
            var = self.s[f"{name}.running_var"]
        inv = (w / torch.sqrt(var + EPS))[None, :, None, None]
        return self._q((x - mean[None, :, None, None]) * inv
                       + b[None, :, None, None])

    def block(self, prefix, x, train, residual):
        h = self._q(F.gelu(self.bn(f"{prefix}.1", self.conv(f"{prefix}.0", x),
                                   train)))
        h = self.bn(f"{prefix}.4", self.conv(f"{prefix}.3", h), train)
        return self._q(F.gelu(self._q(x + h))) if residual else h

    def linear(self, name, x):
        return F.linear(self._q(x), self._q(self.p[f"{name}.weight"]),
                        self.p[f"{name}.bias"])

    def attention(self, i, x, mask):
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)              # [B, L, C]
        pre = f"self_attention{i}"
        q = self._q(self.linear(f"{pre}.query", tokens))
        k = self._q(self.linear(f"{pre}.key", tokens))
        v = self._q(self.linear(f"{pre}.value", tokens))
        out = torch.stack([_BlockAttention.apply(q[j], k[j], v[j], mask[j])
                           for j in range(b)])
        out = F.layer_norm(self._q(out) + tokens, (c,),
                           self.p[f"{pre}.norm.weight"],
                           self.p[f"{pre}.norm.bias"], EPS)
        return self._q(out.transpose(1, 2).reshape(b, c, h, w))

    def __call__(self, images: torch.Tensor, masks, *, train: bool,
                 keep_masks=None) -> dict:
        """images [B, H, W, 3] f32 in [0, 1]; masks: six [B, L] bool key
        masks; keep_masks: the two decoder dropout keep masks (NHWC) in
        train. Returns NHWC 'semantic' and, where the heads exist,
        'embeddings' and 'boundary'."""
        x = images.permute(0, 3, 1, 2).float()
        x1 = self.block("initial_conv.conv_block", x, train, False)
        skips = [x1]
        h = x1
        for i in (1, 2, 3):
            pre = f"downsample{i}.maxpool_conv"
            h = F.max_pool2d(h, 2)
            h = self.block(f"{pre}.1.conv_block", h, train, True)
            h = self.block(f"{pre}.2.conv_block", h, train, False)
            h = self.attention(i, self.bn(f"{pre}.3", h, train), masks[i - 1])
            skips.append(h)
        for i in (1, 2, 3):
            h = self.block(f"bottom{i}.conv_block", h, train, False)
        for i in (1, 2, 3):
            pre = f"upsample{i}.conv"
            h = self._q(F.interpolate(h, scale_factor=2, mode="bilinear",
                                      align_corners=True))
            h = torch.cat([skips[3 - i], h], dim=1)
            h = self.block(f"{pre}.0.conv_block", h, train, True)
            h = self.block(f"{pre}.1.conv_block", h, train, False)
            h = self.bn(f"{pre}.2", h, train)
            if train and i < 3 and self.rate > 0:
                keep = keep_masks[i - 1].permute(0, 3, 1, 2)
                h = torch.where(keep, h / (1 - self.rate), 0.0)
            h = self.attention(3 + i, h, masks[2 + i])
        h = self._q(F.layer_norm(h, tuple(h.shape[1:]), self.p["norm.weight"],
                                 self.p["norm.bias"], EPS))

        def head(name, t):
            return torch.relu(self.bn(f"{name}.1", self.conv(f"{name}.0", t),
                                      train))

        sem = head("final_layer", h)
        out = {"semantic": sem.permute(0, 2, 3, 1)}
        if self.embed_dim > 0:
            out["embeddings"] = head("embedding_head", h).permute(0, 2, 3, 1)
        if self.with_boundary_head:
            bnd = self.conv("boundary_head.3", head("boundary_head", sem))
            out["boundary"] = bnd.permute(0, 2, 3, 1)
        return out
