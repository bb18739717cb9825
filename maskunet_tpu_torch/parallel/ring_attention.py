"""Ring attention: sequence-parallel masked attention over a process group.

Counterpart of maskunet_tpu/parallel/ring_attention.py. Tokens are
sharded over a 'seq' axis; each rank holds its query shard and streams
every key/value shard through an online (streaming) softmax while the
K/V shards and their key bias rotate around the ring, one hop a step:
rank r sends to r + 1 and receives from r - 1 (`_RingPermute`, point to
point by `dist.batch_isend_irecv`). The arithmetic is `_ring_core`'s in
JAX: f32 scores, the running max, the safe masked softmax of
`ops.attention.masked_attention_dense`, so a fully-masked row gives 0,
not NaN. It is plain PyTorch (matmuls in f32), as JAX's is plain JAX
outside any Pallas kernel. Gradients come from autograd through the
steps and the permute (whose backward sends the other way round). A
rank's memory is O(Lq_local * Lk_local) a step, never L x L.

The 'seq' axis is the process group of the `mesh` given (`mesh.group`,
e.g. `parallel.mesh.make_mesh(n)` in a process group of n): the ranks
in its order hold the token shards in order. A divergence from JAX:
JAX's functions take global arrays that GSPMD shards; here each rank
passes its own token shard and gets its own output shard back
(`parallel.mesh.shard_tokens` takes the shard), and the weights are
whole on every rank. A caller that needs their gradients whole sums them
over the group (`parallel.mesh.all_reduce_`). Without a group (`mesh`
None, or a mesh of one process) the ring has one rank and this is the
dense attention.

The transport is chosen by the group's backend, never by trial
(`transport`): NCCL sends the shards on the card; gloo's send and receive
read host memory only (a CUDA tensor fails there with "Bad address": an
H100 under torch 2.11.0+cu128), so on gloo a CUDA shard is copied to a
host buffer, sent, received into a host buffer and copied back to its
device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from maskunet_tpu_torch.core import layers

NEG_INF = -1e30


def transport(group, t: torch.Tensor) -> str:
    """How the permute moves `t` over `group` (the module docstring)."""
    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        return "gloo, through host buffers"
    return backend


def _exchange(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """`t` sent `step` places along the ring (+1 or -1); the tensor that
    arrives from the other side."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    host = transport(group, t) == "gloo, through host buffers"
    send = t.detach().contiguous()
    if host:
        send = send.cpu()
    recv = torch.empty_like(send)
    peer = lambda i: dist.get_global_rank(group, i % n)  # noqa: E731
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, peer(r + step), group),
            dist.P2POp(dist.irecv, recv, peer(r - step), group)]):
        req.wait()
    return recv.to(t.device) if host else recv


class _RingPermute(torch.autograd.Function):
    """Forward: to rank r + 1, from r - 1. Backward: the reverse."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group, +1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -1), None


def ring_permute(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable ring shift over `group`; the identity for a ring of
    one (no group)."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _RingPermute.apply(t, group)


def _ring_core(q, k, v, bias, *, scale: float, group) -> torch.Tensor:
    """q: [B, Lq_loc, C]; k/v: [B, Lk_loc, C]; bias: [B, Lk_loc] additive
    {0, NEG_INF}. Returns [B, Lq_loc, C] in q's dtype. The ring's n steps
    (JAX's scan); the last step's shards are not sent on, since no step
    reads them."""
    n = 1 if group is None else dist.get_world_size(group)
    b, lq, c = q.shape
    qf = q.float()
    acc = q.new_zeros((b, lq, c), dtype=torch.float32)
    m = q.new_full((b, lq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, lq), dtype=torch.float32)
    for i in range(n):
        s = torch.matmul(qf, k.float().transpose(1, 2)) * scale
        s = s + bias[:, None, :]
        valid = bias[:, None, :] > NEG_INF * 0.5
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * valid
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v.float())
        m = m_new
        if i + 1 < n:
            k, v, bias = (ring_permute(t, group) for t in (k, v, bias))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def ring_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor | None, *, mesh,
                          scale: float | None = None) -> torch.Tensor:
    """This rank's token shard of q/k/v [B, L_loc, C] and of key_mask
    [B, L_loc] (bool, True = visible) or None; returns this rank's shard
    of the output [B, L_loc, C]."""
    c = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (c ** 0.5)
    if key_mask is None:
        bias = q.new_zeros(q.shape[:2], dtype=torch.float32)
    else:
        bias = torch.where(key_mask, 0.0, NEG_INF).float()
    return _ring_core(q, k, v, bias, scale=scale,
                      group=None if mesh is None else mesh.group)


def ring_spatial_attention(params: dict, tokens: torch.Tensor,
                           key_mask: torch.Tensor | None, *,
                           mesh) -> torch.Tensor:
    """The attention block (projections, ring core, residual, LayerNorm)
    on this rank's token shard [B, L_loc, C] (and key-mask shard): its
    output shard. `params` as `ops.attention.attention_init`'s."""
    c = tokens.shape[-1]
    q, k, v = (layers.linear(params[f"{n}.weight"], params[f"{n}.bias"],
                             tokens) for n in ("query", "key", "value"))
    out = ring_masked_attention(q, k, v, key_mask, mesh=mesh,
                                scale=1.0 / (c ** 0.5))
    return layers.layernorm(params["norm.weight"], params["norm.bias"],
                            out + tokens)
