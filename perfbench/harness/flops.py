"""The yardstick's arithmetic: the card's peaks, the attention kernels'
least times, and the model's tensor-core FLOPs.

Peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): 989.4e12
bf16 FLOP/s on the tensor cores, 3.35e12 bytes/s of HBM; exp2 on the
special function units at 16 results a clock and SM (CUDA C++ Programming
Guide, compute capability 9.0) x 132 SMs x 1.98 GHz.

The least time of an attention kernel is the largest of its bytes over
the bandwidth, its products over the bf16 peak and its exponentials over
the exp2 peak. Everything is counted from the masks: the visible (query,
key) pairs and the visible keys' K and V, whatever capacity the program's
compaction gives the keys. The forward (K1, K2) reads q, the visible k and
v, a 4-byte bias a visible key, and writes o; it does two products (4
FLOP a visible pair and channel) and one exp2 a pair. The backward (K4)
reads q, o, dO, the visible k and v, lse and delta (4 bytes a query each)
and the bias, writes dQ in f32, dK and dV; it does five products (10 FLOP
a pair and channel) and one exp2 a pair.

The model's FLOPs (after `maskunet_tpu_torch/tools/mfu_report.py`): convs
2*h*w*kh*kw*cin*cout, the bilinear upsamples as their two interpolation
matmuls, and the attention's QKV projections and two score-shaped
products over the visible pairs; a training step is three times the
convs (the forward, dX and dW) and the attention's forward plus twice its
projections and five score-shaped products. Norms, activations, the loss
and AdamW are not tensor-core work and are not counted.
"""

from __future__ import annotations

from perfbench.reference.model import ATTN_CHANNELS, attention_lengths

PEAK_BF16 = 989.4e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 16 * 132 * 1.98e9


def attn_fwd_bound_s(rows: int, lq: int, visible: int, c: int,
                     elt: int = 2) -> float:
    """Least seconds of one forward launch over `rows` images of `lq`
    queries, `visible` keys visible summed over the rows."""
    nbytes = 2 * rows * lq * c * elt + 2 * visible * c * elt + 4 * visible
    return max(nbytes / PEAK_BYTES, 4 * lq * visible * c / PEAK_BF16,
               lq * visible / PEAK_EXP2)


def attn_bwd_bound_s(rows: int, lq: int, visible: int, c: int,
                     elt: int = 2) -> float:
    """Least seconds of one backward launch (K4)."""
    nbytes = (4 * rows * lq * c + 4 * visible * c) * elt + 8 * rows * lq \
        + 4 * visible + 4 * rows * lq * c
    return max(nbytes / PEAK_BYTES, 10 * lq * visible * c / PEAK_BF16,
               lq * visible / PEAK_EXP2)


def visible_keys(masks) -> list[int]:
    """Visible keys of each layer, summed over the rows."""
    return [int(m.sum()) for m in masks]


def attention_bounds(masks) -> dict:
    """{'fwd': s, 'bwd': s}: the least seconds of one call's six forward
    and six backward launches over these masks ([rows, L] each)."""
    fwd = bwd = 0.0
    for m, c, vis in zip(masks, ATTN_CHANNELS, visible_keys(masks)):
        rows, lq = m.shape
        fwd += attn_fwd_bound_s(rows, lq, vis, c)
        bwd += attn_bwd_bound_s(rows, lq, vis, c)
    return {"fwd": fwd, "bwd": bwd}


def _conv(h, w, k, cin, cout):
    return 2 * h * w * k * k * cin * cout


def _block(h, w, cin, cout, mid=None):
    mid = cout if mid is None else mid
    return _conv(h, w, 3, cin, mid) + _conv(h, w, 3, mid, cout)


def conv_flops(img: int, cfg: dict) -> int:
    """Convolution and upsample FLOPs of one image's forward."""
    s = img
    f = _block(s, s, 3, 64)
    f += _block(s // 2, s // 2, 64, 64) + _block(s // 2, s // 2, 64, 128)
    f += _block(s // 4, s // 4, 128, 128) + _block(s // 4, s // 4, 128, 256)
    f += _block(s // 8, s // 8, 256, 256) + _block(s // 8, s // 8, 256, 256)
    f += _block(s // 8, s // 8, 256, 512) + _block(s // 8, s // 8, 512, 512)
    f += _block(s // 8, s // 8, 512, 256)
    f += _block(s // 4, s // 4, 512, 512)
    f += _block(s // 4, s // 4, 512, 128, mid=256)
    f += _block(s // 2, s // 2, 256, 256)
    f += _block(s // 2, s // 2, 256, 64, mid=128)
    f += _block(s, s, 128, 128) + _block(s, s, 128, 64, mid=64)
    f += _conv(s, s, 1, 64, cfg["c_out"])
    if cfg["embed_dim"] > 0:
        f += _conv(s, s, 1, 64, cfg["embed_dim"])
    if cfg["with_boundary_head"]:
        f += _conv(s, s, 3, cfg["c_out"], 32) + _conv(s, s, 1, 32, 1)
    for t, ch in ((s // 4, 256), (s // 2, 128), (s, 64)):
        f += 2 * t * (t // 2) * (t // 2) * ch + 2 * t * t * (t // 2) * ch
    return f


def model_flops(img: int, cfg: dict, masks) -> dict:
    """FLOPs of one call over the masks' rows: {'fwd': ..., 'train': ...}
    for all rows together. masks: six [rows, L] bool (None: every key
    visible)."""
    rows = 1 if masks is None else masks[0].shape[0]
    conv = conv_flops(img, cfg) * rows
    vis = ([rows * n for n in attention_lengths(img)] if masks is None
           else visible_keys(masks))
    proj = score = 0
    for lq, c, v in zip(attention_lengths(img), ATTN_CHANNELS, vis):
        proj += rows * 2 * lq * c * 3 * c
        score += 2 * lq * v * c
    attn_fwd = proj + 2 * score
    return {"fwd": conv + attn_fwd,
            "train": 3 * conv + attn_fwd + 2 * proj + 5 * score}
