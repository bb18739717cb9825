"""MaskAttn-UNet as plain functions over flat state dicts.

Counterpart of maskunet_tpu/models/maskattn_unet.py (same topology; the
docstring there draws it). Parameters live in two flat dicts keyed by the
reference's own state_dict names (ade_semantic.py:192-314), so that
`{**params, **state}` is a reference state_dict without
`num_batches_tracked`:

- `params`: conv and linear `weight`/`bias`, BatchNorm and LayerNorm affine
  `weight`/`bias` (the final joint LayerNorm as [C, H, W]);
- `state`: BatchNorm `running_mean`/`running_var`.

Feature maps are NHWC. The attention layers always take the flash path
(`attn_impl` 'auto' resolves to 'flash'): the kernels on the card, their
plain versions on the CPU. `train=True` runs batch-statistics BatchNorm
(returning the new running stats), dropout at the two decoder sites and,
under autograd, the flash backward. `quantize_params_for_inference` turns
the folded convs into int8 (`layers.conv2d_int8`), after an optional
`calibrate_activation_scales`.

`mesh=` (`parallel.mesh.make_mesh`) is the data axis: each rank runs the
forward on its own rows, and train-mode BatchNorm all-reduces its
statistics over the mesh's process group (cross-replica BN). This is the
counterpart of JAX's `_flash_mha_sharded` (maskunet_tpu/ops/
flash_attention.py:570-587) too: there `shard_map` runs the Pallas kernel
on each device's rows; here each rank launches K1/K2/K4 on its own rows,
and the kernels are the single-device ones.

A mesh with a 'model' axis (`n_model > 1`, tensor parallelism) shards the
512-wide bottleneck as JAX's seam does (maskunet_tpu/models/
maskattn_unet.py:366-371: bottom1's and bottom2's outputs channel-sharded
over 'model', bottom3's whole): each model shard computes its
1/n_model of the output channels of the four convs of bottom1 and bottom2
and their BatchNorms (`_bottleneck_tp`), the channels are gathered before
each conv whose input is sharded and before bottom3, and everything else
runs whole on every model rank (the attention kernels too, on the data
rank's rows, as JAX's `_flash_mha_sharded` replicates them over 'model').
In a process group each rank computes its own shard; one process without
a group (serving's mesh) runs every shard, each on its device, and
gathers by copy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from maskunet_tpu_torch.core import initializers as init_lib
from maskunet_tpu_torch.core import layers
from maskunet_tpu_torch.ops import attention
from maskunet_tpu_torch.ops import flash_attention as fa


@dataclasses.dataclass(frozen=True)
class MaskAttnUNetConfig:
    c_in: int = 3
    c_out: int = 150
    img_size: int = 128
    embed_dim: int = 0          # >0 adds the instance-embedding head
    with_boundary_head: bool = False
    dropout_rate: float = 0.3
    attn_impl: str = "auto"     # 'dense' | 'flash' | 'auto' (-> 'flash')
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16'
    remat_attention: bool = False
    attn_output_layout: str = "transpose"  # 'transpose' | 'literal_view'

    @property
    def multi_head_output(self) -> bool:
        return self.embed_dim > 0 or self.with_boundary_head

    def resolve_attn_impl(self) -> str:
        return "flash" if self.attn_impl == "auto" else self.attn_impl

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


class ModelOutput(NamedTuple):
    semantic: torch.Tensor                  # [B, H, W, c_out]
    boundary: torch.Tensor | None = None    # [B, H, W, 1]
    embeddings: torch.Tensor | None = None  # [B, H, W, embed_dim]


_ATTN_SCALES = (2, 4, 8, 4, 2, 1)   # attn1..attn6 run at img_size // scale
ATTN_CHANNELS = (128, 256, 256, 128, 64, 64)
_DOWN = ((64, 128), (128, 256), (256, 256))
_BOTTOM = ((256, 512), (512, 512), (512, 256))
_UP = ((512, 128), (256, 64), (128, 64))


def attention_mask_sizes(img_size: int) -> tuple[int, ...]:
    return tuple((img_size // s) ** 2 for s in _ATTN_SCALES)


def make_attention_masks(generator: torch.Generator, batch: int,
                         img_size: int = 128) -> tuple[torch.Tensor, ...]:
    """One Bernoulli(0.5) key mask [B, L_i] per attention layer."""
    return tuple(attention.random_key_mask(generator, batch, n)
                 for n in attention_mask_sizes(img_size))


def precompute_mask_plans(masks: tuple[torch.Tensor, ...] | None
                          ) -> tuple | None:
    """Compaction plans of the run-cached masks: a plan for each layer of
    >= COMPACT_MIN_TOKENS tokens, None for the others."""
    if masks is None:
        return None
    return tuple(fa.plan_compaction(m)
                 if m is not None and m.shape[-1] >= fa.COMPACT_MIN_TOKENS
                 else None for m in masks)


# ---------------------------------------------------------------------------
# Parameter names (the reference's modules) and init
# ---------------------------------------------------------------------------

def _convblocks() -> list[str]:
    """state_dict prefix of every ConvBlock."""
    out = ["initial_conv.conv_block"]
    for i in (1, 2, 3):
        out += [f"downsample{i}.maxpool_conv.1.conv_block",
                f"downsample{i}.maxpool_conv.2.conv_block",
                f"bottom{i}.conv_block",
                f"upsample{i}.conv.0.conv_block",
                f"upsample{i}.conv.1.conv_block"]
    return out


def _conv_init(gen, params, name, cin, cout, ksize, use_bias):
    params[f"{name}.weight"] = init_lib.conv_kernel(gen, ksize, ksize, cin,
                                                    cout)
    if use_bias:
        params[f"{name}.bias"] = init_lib.torch_uniform(
            gen, (cout,), cin * ksize * ksize)


def _bn_init(params, state, name, c):
    params[f"{name}.weight"] = torch.ones(c)
    params[f"{name}.bias"] = torch.zeros(c)
    state[f"{name}.running_mean"] = torch.zeros(c)
    state[f"{name}.running_var"] = torch.ones(c)


def _block_channels(prefix: str, cfg: MaskAttnUNetConfig
                    ) -> tuple[int, int, int]:
    """(cin, mid, cout) of the ConvBlock at `prefix`."""
    if prefix.startswith("initial"):
        return cfg.c_in, 64, 64
    i = int(prefix.split(".")[0][-1]) - 1
    if prefix.startswith("downsample"):
        cin, cout = _DOWN[i]
        return (cin, cin, cin) if ".1." in prefix else (cin, cout, cout)
    if prefix.startswith("bottom"):
        cin, cout = _BOTTOM[i]
        return cin, cout, cout
    cin, cout = _UP[i]
    return (cin, cin, cin) if ".0." in prefix else (cin, cin // 2, cout)


def init(generator: torch.Generator, cfg: MaskAttnUNetConfig
         ) -> tuple[dict, dict]:
    """Fresh (params, state) on the generator's device, torch defaults."""
    params: dict[str, torch.Tensor] = {}
    state: dict[str, torch.Tensor] = {}
    for prefix in _convblocks():
        cin, mid, cout = _block_channels(prefix, cfg)
        _conv_init(generator, params, f"{prefix}.0", cin, mid, 3, False)
        _bn_init(params, state, f"{prefix}.1", mid)
        _conv_init(generator, params, f"{prefix}.3", mid, cout, 3, False)
        _bn_init(params, state, f"{prefix}.4", cout)
    for i, (_, cout) in enumerate(_DOWN, 1):
        _bn_init(params, state, f"downsample{i}.maxpool_conv.3", cout)
    for i, (_, cout) in enumerate(_UP, 1):
        _bn_init(params, state, f"upsample{i}.conv.2", cout)
    for i, ch in enumerate(ATTN_CHANNELS, 1):
        for k, v in attention.attention_init(generator, ch).items():
            params[f"self_attention{i}.{k}"] = v
    n = cfg.img_size
    params["norm.weight"] = torch.ones(64, n, n)
    params["norm.bias"] = torch.zeros(64, n, n)
    _conv_init(generator, params, "final_layer.0", 64, cfg.c_out, 1, True)
    _bn_init(params, state, "final_layer.1", cfg.c_out)
    if cfg.embed_dim > 0:
        _conv_init(generator, params, "embedding_head.0", 64, cfg.embed_dim,
                   1, True)
        _bn_init(params, state, "embedding_head.1", cfg.embed_dim)
    if cfg.with_boundary_head:
        _conv_init(generator, params, "boundary_head.0", cfg.c_out, 32, 3,
                   True)
        _bn_init(params, state, "boundary_head.1", 32)
        _conv_init(generator, params, "boundary_head.3", 32, 1, 1, True)
    dev = generator.device
    return ({k: v.to(dev) for k, v in params.items()},
            {k: v.to(dev) for k, v in state.items()})


def param_count(params: dict) -> int:
    return sum(int(t.numel()) for t in params.values())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(p: dict, name: str, x: torch.Tensor,
          out: slice | None = None) -> torch.Tensor:
    """The conv `name`, or its output channels `out` (on x's device): int8
    where `quantize_params_for_inference` left its `kernel_q`, float
    otherwise. The whole conv gets the parameter tensors themselves (the
    calibration recorder knows a conv by its weight)."""
    def get(key):
        t = p.get(f"{name}.{key}")
        return t if t is None or out is None else t[out].to(x.device)

    if f"{name}.kernel_q" in p:
        return layers.conv2d_int8(get("kernel_q"), get("w_scale"),
                                  get("bias"), x,
                                  a_scale=p.get(f"{name}.a_scale"))
    return layers.conv2d(get("weight"), get("bias"), x)


class _BatchNorms:
    """The forward's BatchNorms: eval (running stats), train (batch stats;
    the new running stats are collected in `new_state`) or folded (the
    identity: the affines live in the convs)."""

    def __init__(self, params: dict, state: dict | None, *, train: bool,
                 folded: bool, group=None):
        self.params, self.state = params, state
        self.train, self.folded, self.group = train, folded, group
        self.new_state: dict[str, torch.Tensor] = {}

    def __call__(self, name: str, x: torch.Tensor,
                 channels: slice | None = None):
        """BatchNorm `name` on x, or on its `channels` of the BatchNorm's
        (on x's device; the new running stats are then those channels')."""
        if self.folded:
            return x
        p, s = self.params, self.state
        args = [t if channels is None else t[channels].to(x.device)
                for t in (p[f"{name}.weight"], p[f"{name}.bias"],
                          s[f"{name}.running_mean"],
                          s[f"{name}.running_var"])]
        if not self.train:
            return layers.batchnorm(*args, x)
        y, mean, var = layers.batchnorm_train(*args, x, group=self.group)
        self.new_state[f"{name}.running_mean"] = mean
        self.new_state[f"{name}.running_var"] = var
        return y

    def result(self) -> dict:
        """The state `encode`/`decode` return: the new running stats in
        train, the state itself in eval, nothing when folded."""
        if self.folded:
            return {}
        return self.new_state if self.train else self.state


def _convblock(p, bn, prefix, x, *, residual):
    h = bn(f"{prefix}.1", _conv(p, f"{prefix}.0", x))
    h = layers.gelu(h)
    h = bn(f"{prefix}.4", _conv(p, f"{prefix}.3", h))
    return layers.gelu(x + h) if residual else h


def _down(p, bn, i, x):
    x = layers.max_pool_2x(x)
    pre = f"downsample{i}.maxpool_conv"
    x = _convblock(p, bn, f"{pre}.1.conv_block", x, residual=True)
    x = _convblock(p, bn, f"{pre}.2.conv_block", x, residual=False)
    return bn(f"{pre}.3", x)


def _up(p, bn, i, x, skip):
    x = layers.upsample_2x_bilinear(x)
    x = torch.cat([skip, x], dim=-1)      # [skip, x] order, ref :253
    pre = f"upsample{i}.conv"
    x = _convblock(p, bn, f"{pre}.0.conv_block", x, residual=True)
    x = _convblock(p, bn, f"{pre}.1.conv_block", x, residual=False)
    return bn(f"{pre}.2", x)


_ATTN_KEYS = ("query.weight", "query.bias", "key.weight", "key.bias",
              "value.weight", "value.bias", "norm.weight", "norm.bias")


def _attn(params, i, x, masks, plans, cfg, train):
    """Attention block i; with `remat_attention` in training it is
    recomputed in the backward (non-reentrant checkpoint) instead of
    keeping its activations."""
    p = {k: params[f"self_attention{i}.{k}"] for k in _ATTN_KEYS}

    def fn(p_, x_, mask, plan):
        return attention.spatial_attention(
            p_, x_, mask, impl=cfg.resolve_attn_impl(), plan=plan,
            output_layout=cfg.attn_output_layout)

    if cfg.remat_attention and train:
        return torch.utils.checkpoint.checkpoint(
            fn, p, x, masks[i - 1], plans[i - 1], use_reentrant=False)
    return fn(p, x, masks[i - 1], plans[i - 1])


def _check(train: bool, mesh, folded: bool):
    """The BatchNorm group of `mesh` (its data axis), after the refusal."""
    if folded and train:
        raise ValueError("folded params are eval-only")
    return None if mesh is None else mesh.group


# the bottleneck convs that the 'model' axis shards by output channels
TP_CONVS = tuple(f"bottom{i}.conv_block.{k}" for i in (1, 2) for k in (0, 3))


def tp_sharded(key: str) -> bool:
    """Whether the parameter `key` is computed in slices over 'model':
    every parameter of bottom1 and bottom2 (under TP its gradient on a
    rank is nonzero on that rank's slice only)."""
    return key.startswith(("bottom1.", "bottom2."))


def _bottleneck_tp(params, bn, x, mesh):
    """bottom1-3 over the mesh's 'model' axis (the module docstring): each
    shard runs the four convs of bottom1 and bottom2 on its output
    channels with their BatchNorms; the channels are gathered before every
    conv but the first, whose whole input each shard takes as it is, and
    before bottom3, which runs whole. Returns bottom3's output."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    home = x.device
    ranked = mesh.model_group is not None
    shards = ([(mesh_lib.channels_tp_spec(mesh, 512), home)] if ranked
              else [(mesh_lib.channels_tp_spec(mesh, 512, j), mesh.devices[j])
                    for j in range(mesh.n_model)])

    def gather(hs, consumer):
        """The whole channels, on each shard's device."""
        if ranked:
            return [mesh_lib.gather_channels(hs[0], mesh, consumer=consumer)]
        whole = torch.cat([h.to(home) for h in hs], dim=-1)
        return [whole.to(dev) for _, dev in shards]

    xs = ([mesh_lib.model_parallel_input(x, mesh)] if ranked
          else [x.to(dev) for _, dev in shards])
    for i, name in enumerate(TP_CONVS):
        if i:
            xs = gather(xs, "sharded")
        prefix, k = name.rsplit(".", 1)
        norm = f"{prefix}.{int(k) + 1}"
        outs, stats = [], []
        for (sl, _), h in zip(shards, xs):
            h = bn(norm, _conv(params, name, h, sl), sl)
            outs.append(layers.gelu(h) if k == "0" else h)   # _convblock
            stats.append([bn.new_state.get(f"{norm}.running_{s}")
                          for s in ("mean", "var")])
        xs = outs
        if bn.train:    # the shards' new running stats, whole
            for s, parts in zip(("mean", "var"), zip(*stats)):
                bn.new_state[f"{norm}.running_{s}"] = (
                    mesh_lib.gather_model_slices(parts[0], mesh) if ranked
                    else torch.cat([t.to(home) for t in parts]))
    x = gather(xs, "replicated")[0].to(home)
    return _convblock(params, bn, "bottom3.conv_block", x, residual=False)


def encode(params: dict, state: dict | None, x: torch.Tensor, *,
           cfg: MaskAttnUNetConfig,
           masks: tuple[torch.Tensor, ...] | None = None,
           train: bool = False, mesh=None, folded: bool = False,
           mask_plans: tuple | None = None):
    """Encoder: initial block, down1-3 with attn1-3, bottleneck. Returns
    ((x1, x2, x3, x4), new_state): in train the encoder's new running
    stats."""
    group = _check(train, mesh, folded)
    masks = masks if masks is not None else (None,) * 6
    plans = mask_plans if mask_plans is not None else (None,) * 6
    bn = _BatchNorms(params, state, train=train, folded=folded, group=group)
    x = x.to(cfg.dtype)
    x1 = _convblock(params, bn, "initial_conv.conv_block", x, residual=False)
    x2 = _attn(params, 1, _down(params, bn, 1, x1), masks, plans, cfg, train)
    x3 = _attn(params, 2, _down(params, bn, 2, x2), masks, plans, cfg, train)
    x4 = _attn(params, 3, _down(params, bn, 3, x3), masks, plans, cfg, train)
    if mesh is not None and mesh.n_model > 1:
        x4 = _bottleneck_tp(params, bn, x4, mesh)
    else:
        for i in (1, 2, 3):
            x4 = _convblock(params, bn, f"bottom{i}.conv_block", x4,
                            residual=False)
    return (x1, x2, x3, x4), bn.result()


def decode(params: dict, state: dict | None, skips, *,
           cfg: MaskAttnUNetConfig,
           masks: tuple[torch.Tensor, ...] | None = None,
           train: bool = False,
           dropout_generator: torch.Generator | None = None,
           mesh=None, folded: bool = False,
           mask_plans: tuple | None = None,
           dropout_masks: tuple | None = None) -> tuple[ModelOutput, dict]:
    """Decoder: up1-3 with attn4-6, dropout after up1 and up2 (train
    only), joint final LayerNorm, heads (ReLU on the logits, as the
    reference). Dropout draws its keep masks from `dropout_generator`, or
    takes them from `dropout_masks` (shapes `decoder_dropout_shapes`)."""
    group = _check(train, mesh, folded)
    masks = masks if masks is not None else (None,) * 6
    plans = mask_plans if mask_plans is not None else (None,) * 6
    keep = dropout_masks if dropout_masks is not None else (None, None)
    if (train and cfg.dropout_rate > 0 and dropout_masks is None
            and dropout_generator is None):
        raise ValueError("dropout_generator required when train=True")
    bn = _BatchNorms(params, state, train=train, folded=folded, group=group)
    x1, x2, x3, x4 = skips

    def drop(h, i):
        return layers.dropout(h, rate=cfg.dropout_rate,
                              generator=dropout_generator, train=train,
                              keep_mask=keep[i])

    h = drop(_up(params, bn, 1, x4, x3), 0)
    h = _attn(params, 4, h, masks, plans, cfg, train)
    h = drop(_up(params, bn, 2, h, x2), 1)
    h = _attn(params, 5, h, masks, plans, cfg, train)
    h = _attn(params, 6, _up(params, bn, 3, h, x1), masks, plans, cfg, train)
    h = layers.layernorm(params["norm.weight"].permute(1, 2, 0),
                         params["norm.bias"].permute(1, 2, 0), h)

    def head(name, x):
        return bn(f"{name}.1", _conv(params, f"{name}.0", x))

    sem = torch.relu(head("final_layer", h))
    boundary = embeddings = None
    if cfg.embed_dim > 0:
        embeddings = torch.relu(head("embedding_head", h))
    if cfg.with_boundary_head:
        b = torch.relu(head("boundary_head", sem))
        boundary = _conv(params, "boundary_head.3", b)
    return ModelOutput(sem, boundary, embeddings), bn.result()


def decoder_dropout_shapes(cfg: MaskAttnUNetConfig,
                           batch: int) -> tuple[tuple, tuple]:
    """Shapes of the two decoder dropout sites (after up1 and up2), for
    `decode(..., dropout_masks=...)`."""
    n = cfg.img_size
    return ((batch, n // 4, n // 4, 128), (batch, n // 2, n // 2, 64))


def draw_dropout_masks(generator: torch.Generator, cfg: MaskAttnUNetConfig,
                       batch: int) -> tuple | None:
    """The two decoder keep masks for `batch` rows, drawn from `generator`
    in the order the forward draws them itself (so a forward on these
    masks equals one that draws), or None without dropout."""
    if cfg.dropout_rate <= 0:
        return None
    return tuple(layers.dropout_keep_mask(generator, cfg.dropout_rate, shape)
                 for shape in decoder_dropout_shapes(cfg, batch))


def apply(params: dict, state: dict | None, x: torch.Tensor, *,
          cfg: MaskAttnUNetConfig,
          masks: tuple[torch.Tensor, ...] | None = None,
          train: bool = False,
          dropout_generator: torch.Generator | None = None,
          mesh=None, folded: bool = False,
          mask_plans: tuple | None = None,
          dropout_masks: tuple | None = None) -> tuple[ModelOutput, dict]:
    """Forward. x: [B, H, W, c_in] NHWC. `masks`: per-layer key masks
    (None: all keys visible); `mask_plans`: `precompute_mask_plans(masks)`;
    `folded`: `params` came from `fold_bn_for_inference` (state unused).
    `train`: batch-statistics BatchNorm and dropout (keep masks drawn from
    `dropout_generator`, or `dropout_masks`). `mesh`: the data axis (this
    rank's rows in `x` and `masks`; see the module docstring). Returns
    (output, state): in train the new running stats of every BatchNorm, in
    eval `state` itself."""
    skips, enc_state = encode(params, state, x, cfg=cfg, masks=masks,
                              train=train, mesh=mesh, folded=folded,
                              mask_plans=mask_plans)
    out, dec_state = decode(params, state, skips, cfg=cfg, masks=masks,
                            train=train, dropout_generator=dropout_generator,
                            mesh=mesh, folded=folded, mask_plans=mask_plans,
                            dropout_masks=dropout_masks)
    return out, ({**enc_state, **dec_state} if train else dec_state)


# ---------------------------------------------------------------------------
# Serving transforms
# ---------------------------------------------------------------------------

def _bn_affine(params, state, name, eps=1e-5):
    """Eval BatchNorm `name` as per-channel (a, b): y = a*x + b."""
    a = params[f"{name}.weight"] * torch.rsqrt(
        state[f"{name}.running_var"] + eps)
    return a, params[f"{name}.bias"] - state[f"{name}.running_mean"] * a


def _fold_conv(params, name, a, b, out):
    out[f"{name}.weight"] = params[f"{name}.weight"] * a[:, None, None, None]
    bias = params.get(f"{name}.bias")
    out[f"{name}.bias"] = bias * a + b if bias is not None else b


def fold_bn_for_inference(params: dict, state: dict,
                          cfg: MaskAttnUNetConfig) -> dict:
    """Every eval BatchNorm folded into the conv before it, including the
    Down/Up blocks' trailing BN chained onto their second block's BN.
    The result runs with `apply(..., folded=True)`; exact in f32."""
    out: dict[str, torch.Tensor] = {}
    trailing = {f"downsample{i}.maxpool_conv.2.conv_block":
                f"downsample{i}.maxpool_conv.3" for i in (1, 2, 3)}
    trailing.update({f"upsample{i}.conv.1.conv_block": f"upsample{i}.conv.2"
                     for i in (1, 2, 3)})
    for prefix in _convblocks():
        a1, b1 = _bn_affine(params, state, f"{prefix}.1")
        a2, b2 = _bn_affine(params, state, f"{prefix}.4")
        if prefix in trailing:
            a3, b3 = _bn_affine(params, state, trailing[prefix])
            a2, b2 = a2 * a3, b2 * a3 + b3
        _fold_conv(params, f"{prefix}.0", a1, b1, out)
        _fold_conv(params, f"{prefix}.3", a2, b2, out)
    for k, v in params.items():
        if k.startswith("self_attention") or k.startswith("norm."):
            out[k] = v
    heads = ["final_layer"]
    if cfg.embed_dim > 0:
        heads.append("embedding_head")
    if cfg.with_boundary_head:
        heads.append("boundary_head")
        out["boundary_head.3.weight"] = params["boundary_head.3.weight"]
        out["boundary_head.3.bias"] = params["boundary_head.3.bias"]
    for name in heads:
        a, b = _bn_affine(params, state, f"{name}.1")
        _fold_conv(params, f"{name}.0", a, b, out)
    return out


def cast_params_for_inference(params: dict,
                              dtype: torch.dtype = torch.bfloat16) -> dict:
    """Conv and linear weights and biases pre-cast to the compute dtype;
    norm affines stay f32 (they enter f32 statistics). An int8 conv's
    `kernel_q`, `w_scale` and `a_scale` stay as they are and its bias is
    cast, as JAX casts every `kernel` and `bias` leaf."""
    def cast(key: str) -> bool:
        prefix, leaf = key.rsplit(".", 1)
        w = params.get(f"{prefix}.weight", params.get(f"{prefix}.kernel_q"))
        return leaf in ("weight", "bias") and w is not None \
            and w.dim() in (2, 4)

    return {k: v.to(dtype) if cast(k) else v for k, v in params.items()}


def _conv_names(params: dict) -> list[str]:
    """The prefix of every 4-D conv weight of a flat parameter dict."""
    return [k[:-len(".weight")] for k, v in params.items()
            if k.endswith(".weight") and v.dim() == 4]


def calibrate_activation_scales(params: dict, forward, batches) -> dict:
    """Per-conv input max|x| over calibration batches, from the folded
    float model (maskunet_tpu/models/maskattn_unet.py:522-600).

    `forward(params, x)` runs the model (e.g. `apply(..., folded=True)`)
    on each batch of `batches`, without gradients; while it runs,
    `layers.recording_conv_inputs` shows every conv's input to a recorder
    that keeps the running max on the device, keyed by the conv's name
    (the state_dict prefix, e.g. "initial_conv.conv_block.0", which
    `utils.jax_weights.mapping` relates to JAX's "initial/conv1"). One
    host sync at the end. Returns {name: max}, for
    `quantize_params_for_inference(act_scales=...)`."""
    names = {id(params[f"{n}.weight"]): n for n in _conv_names(params)}
    records: dict[str, torch.Tensor] = {}

    def record(weight: torch.Tensor, x: torch.Tensor) -> None:
        name = names.get(id(weight))
        if name is not None:
            m = x.float().abs().amax()
            records[name] = (m if name not in records
                             else torch.maximum(records[name], m))

    with torch.no_grad(), layers.recording_conv_inputs(record):
        for b in batches:
            forward(params, b)
    if not records:
        raise RuntimeError(
            "calibration recorded no conv activations — `forward` must "
            "call the model with these `params` and must execute at least "
            "one conv")
    keys = list(records)
    values = torch.stack([records[k] for k in keys]).tolist()
    return dict(zip(keys, values))


def quantize_params_for_inference(params: dict,
                                  act_scales: dict | None = None) -> dict:
    """Post-training int8 quantization of the folded conv weights
    (maskunet_tpu/models/maskattn_unet.py:602-654): for every 4-D conv
    `name`, `name.weight` [O, I, kh, kw] becomes `name.kernel_q` =
    clip(round(W / w_scale), -127, 127) in int8 with per-output-channel
    `name.w_scale` = max(max|W[c]|, 1e-12) / 127 (f32); `act_scales` (from
    `calibrate_activation_scales`) adds the static `name.a_scale` =
    max(act, 1e-12) / 127, else `layers.conv2d_int8` scales each sample
    dynamically. Linears stay as they are (they feed the flash kernel in
    the compute dtype). Apply to `fold_bn_for_inference`'s output; the
    class maps are not bit-equal to the float model's."""
    out = dict(params)
    for name in _conv_names(params):
        k = out.pop(f"{name}.weight").float()
        scale = layers.div_127(torch.clamp(k.abs().amax(dim=(1, 2, 3)),
                                           min=1e-12))
        out[f"{name}.kernel_q"] = torch.clamp(
            torch.round(k / scale[:, None, None, None]), -127, 127
        ).to(torch.int8)
        out[f"{name}.w_scale"] = scale
        if act_scales is not None:
            if name not in act_scales:
                raise ValueError(
                    f"no calibrated activation scale for conv {name!r} — "
                    "it was not exercised during calibration (the "
                    "calibration forward must run every conv the serving "
                    "config will execute)")
            out[f"{name}.a_scale"] = torch.tensor(
                max(act_scales[name], 1e-12) / 127.0, dtype=torch.float32,
                device=k.device)
    return out
