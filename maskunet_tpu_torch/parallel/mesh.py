"""The ('data', 'model') mesh: one process per device, a process group for
each axis.

Counterpart of maskunet_tpu/parallel/mesh.py. JAX jits over a ('data',
'model') mesh: params replicated, the batch sharded on 'data', and GSPMD
makes every reduction global. PyTorch's idiom is one process per device
and a `torch.distributed` process group for the axis. The port makes
the reductions global by hand, and each does it the same way:

- BatchNorm's batch statistics: all-reduced Σx, Σx² and count
  (`core/layers.batchnorm_train`), with gradients through the reduce;
- cross-entropy and the triplet term: local sums over global counts, so
  each rank's loss is its share of the global loss; the shares add up;
- the mIoU histograms: all-reduced;
- the gradients: all-reduced sums of the shares' gradients, so every rank
  runs the same AdamW update on the same numbers.

A `Mesh` has one device for each data index. With a process group (after
`init_distributed`), rank r drives `devices[r]`, every rank receives the
same global batch and takes its rows (`shard_batch`), and the state starts
as rank 0's (`put_replicated`). Without one, a single process drives every
device of the mesh: the serving runner's mesh (`serve.py`), as JAX serves
from one controller.

The 'model' axis (`n_model > 1`, tensor parallelism) follows JAX's layout:
`np.asarray(devices).reshape(n_data, n_model)`, so rank r is data index
r // n_model and model index r % n_model. Each rank belongs to two groups:
its data group (the ranks of its model index: BatchNorm, the losses, the
metrics and the replicated gradients reduce over it) and its model group
(the ranks of its data index: the channel gathers of the bottleneck,
`gather_channels`). Params stay whole on every rank; each model rank
computes its slice of the channels (`channels_tp_spec`), where JAX's GSPMD
shards the bottleneck's activations and propagates matching kernel
shardings. gloo has no reduce-scatter: a gather's backward all-reduces and
slices.

The backend is the caller's choice: NCCL on the card, gloo on the CPU and
wherever two ranks share one card (NCCL refuses two ranks on one GPU).
gloo takes CUDA tensors for the three collectives the port uses
(all-reduce, broadcast, all-gather: checked on an H100 under torch
2.11.0+cu128), so every tensor stays on its device; NCCL takes no CPU
tensor, so the few that live on the host (a generator's state, the step)
cross through the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# every process group gets a timeout: a collective that one rank never
# reaches fails after it instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh: `devices[d * n_model + m]` is the device of
    data index d and model index m (a device may appear more than once
    where the caller named it so). `group`: this rank's process group of
    the 'data' axis (the world when `n_model` is 1), `model_group` that of
    the 'model' axis (None when `n_model` is 1); both None where one
    process drives every device."""
    devices: tuple
    group: object = None
    n_model: int = 1
    model_group: object = None
    axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def n_data(self) -> int:
        return len(self.devices) // self.n_model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def rank(self) -> int:
        """This process's data index (0 without a process group)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def model_rank(self) -> int:
        """This process's model index (0 without a model group)."""
        return 0 if self.model_group is None else dist.get_rank(
            self.model_group)

    @property
    def device(self) -> torch.device:
        """The device this process drives."""
        return self.devices[self.rank * self.n_model + self.model_rank]


def _local_index(rank: int) -> int:
    """The card of this process on its host: LOCAL_RANK where a launcher
    set it, else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank))


def default_devices(n: int) -> list[torch.device]:
    """n distinct devices: the cards of this host, or refused (one device
    per data index, as JAX's mesh over `jax.devices()`)."""
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"mesh needs {n} devices, this host has {count} "
                         f"CUDA device{'s' * (count != 1)}")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over the given devices, or by default this
    process's card (`cuda:<local rank>`) for each process of the
    initialised process group, or every card of this host without one.
    `devices` may name one device twice (two ranks on one card): a
    divergence from JAX, whose devices are distinct. Refuses a size that
    does not match the devices, as JAX does. In a process group of
    n_data x n_model ranks with `n_model > 1`, every rank makes every
    data and model group, in the same order."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if devices is None:
        if group is not None:
            # a process knows its own card only: every entry is it
            local = _local_index(dist.get_rank())
            count = torch.cuda.device_count()
            if local >= count:
                raise ValueError(
                    f"mesh needs a card for process {dist.get_rank()} "
                    f"(local index {local}), this host has {count}")
            devices = [torch.device("cuda", local)] * dist.get_world_size()
        else:
            devices = default_devices(n_data * n_model if n_data
                                      else torch.cuda.device_count())
    devices = tuple(torch.device(d) for d in devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model != len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} != {len(devices)} devices")
    if group is None:
        return Mesh(devices, None, n_model)
    if dist.get_world_size() != n_data * n_model:
        raise ValueError(f"mesh of {n_data}x{n_model} ranks in a process "
                         f"group of {dist.get_world_size()}")
    if n_model == 1:
        return Mesh(devices, group)
    data_index, model_index = divmod(dist.get_rank(), n_model)
    groups = [dist.new_group([d * n_model + m for d in range(n_data)],
                             timeout=DEFAULT_TIMEOUT)
              for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)],
                                   timeout=DEFAULT_TIMEOUT)
                    for d in range(n_data)]
    return Mesh(devices, groups[model_index], n_model,
                model_groups[data_index])


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, *,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """The counterpart of `jax.distributed.initialize`: joins this process
    to the default process group. With `coordinator` ("host:port") the
    rendezvous is `tcp://coordinator` with the given size and rank; without
    it, `env://` (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK from the
    launcher), as JAX detects its cluster. `backend`: 'nccl' (default with
    a card) or 'gloo'. With NCCL the process binds its card first."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator}"
    else:
        init_method = "env://"
    if backend == "nccl":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", 0))
        device = torch.device("cuda", _local_index(rank))
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout, **kw)


def check_process_mesh(mesh: Mesh | None) -> None:
    """Training and evaluation run one process per data index: a data
    mesh of several devices without a process group would put all its
    rows on one device, so it is refused (serving drives such a mesh).
    One process may drive the model shards of one data index."""
    if mesh is not None and mesh.group is None and mesh.n_data > 1:
        raise ValueError(
            f"a data mesh of {mesh.n_data} devices trains and evaluates "
            "with one process per device: initialise the process group "
            "(init_distributed) before make_mesh")


def data_group(mesh: Mesh | None):
    """The process group of the 'data' axis, None without one (a single
    process: every reduction is already global)."""
    return None if mesh is None else mesh.group


def world_group(mesh: Mesh | None):
    """The process group of every rank of the mesh (both axes), None
    without one."""
    return None if data_group(mesh) is None else dist.group.WORLD


def is_lead(mesh: Mesh | None) -> bool:
    """Global rank 0 (every single-process run): the one that writes
    checkpoints and logs, as JAX's process 0."""
    return world_group(mesh) is None or dist.get_rank() == 0


def barrier(mesh: Mesh | None) -> None:
    if world_group(mesh) is not None:
        dist.barrier(group=world_group(mesh))


def _on_backend(group, t: torch.Tensor) -> torch.Tensor:
    """`t` where the backend takes it: NCCL takes CUDA tensors only."""
    if dist.get_backend(group) == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (no gradient); returns `t`."""
    if group is None:
        return t
    buf = _on_backend(group, t)
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group whose backward sums the gradients over it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the group: its backward all-reduces the
    gradients, so each rank's share of a global loss back-propagates to
    every rank's inputs. Identity without a group."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """In place: rank `src`'s `t` on every rank."""
    if group is None:
        return t
    buf = _on_backend(group, t)
    dist.broadcast(buf, src=src, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The ranks' `t` concatenated along dim 0 in rank order, on `t`'s
    device."""
    group = data_group(mesh)
    if group is None:
        return t
    src = _on_backend(group, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def move_tree(tree, device):
    """A tensor, or a tuple or named tuple of them (and None), on
    `device`: masks and their compaction plans."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.to(device)
    moved = (move_tree(t, device) for t in tree)
    return type(tree)(*moved) if hasattr(tree, "_fields") else tuple(moved)


def local_rows(mesh: Mesh | None, n_rows: int, n_micro: int = 1):
    """This rank's rows of a global batch of `n_rows` made of `n_micro`
    microbatches: the r-th of n equal parts of each microbatch, as a slice
    (one microbatch) or an index tensor; every row without a data group."""
    n = 1 if data_group(mesh) is None else mesh.n_data
    micro = n_rows // n_micro
    if micro * n_micro != n_rows or micro % n:
        raise ValueError(f"batch {n_rows} in {n_micro} microbatches does not "
                         f"divide over {n} data ranks")
    b, r = micro // n, (0 if n == 1 else mesh.rank)
    if n_micro == 1 or n == 1:
        return slice(r * b, (r + 1) * b) if n_micro == 1 else slice(None)
    return torch.cat([torch.arange(m * micro + r * b, m * micro + (r + 1) * b)
                      for m in range(n_micro)])


def shard_batch(mesh: Mesh | None, batch: dict, n_micro: int = 1) -> dict:
    """This rank's rows (`local_rows`) of every array of a global batch."""
    rows = local_rows(mesh, len(next(iter(batch.values()))), n_micro)
    return {k: v[rows] for k, v in batch.items()}


def shard_tokens(mesh: Mesh | None, t: torch.Tensor,
                 dim: int = 1) -> torch.Tensor:
    """This rank's contiguous 1/n of the token axis `dim` of `t` over the
    mesh's group (ring attention's 'seq' axis, as JAX's P(None, 'seq')
    shards it in device order); all of it without a group."""
    group = data_group(mesh)
    if group is None:
        return t
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"{t.shape[dim]} tokens do not divide over "
                         f"{n} ranks")
    return t.chunk(n, dim=dim)[dist.get_rank(group)]


def shard_masks(mesh: Mesh | None, masks, plans=None):
    """This rank's rows of per-slot attention masks sized for the global
    (micro)batch and of their compaction plans (a plan is per row, so its
    rows are the plan of the mask's rows)."""
    if data_group(mesh) is None or masks is None:
        return masks, plans
    rows = local_rows(mesh, masks[0].shape[0])
    masks = tuple(None if m is None else m[rows] for m in masks)
    if plans is not None:
        plans = tuple(None if p is None else type(p)(*(f[rows] for f in p))
                      for p in plans)
    return masks, plans


def put_replicated(mesh: Mesh | None, ts):
    """Global rank 0's train state on every rank of both axes, in place:
    parameters, BatchNorm statistics, cached masks, optimizer moments, the
    step and the generator (the 'fresh' masks, dropout and triplets are
    drawn on every rank in lockstep from it). Returns `ts`."""
    group = world_group(mesh)
    if group is None:
        return ts
    with torch.no_grad():
        for t in (*ts.params.values(), *ts.model_state.values()):
            broadcast_(t, group)
        for m in ts.masks or ():
            broadcast_(m.view(torch.uint8), group)   # bool, as bytes
        for state in ts.optimizer.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    broadcast_(v, group)
    step = torch.tensor([ts.step], dtype=torch.int64)
    ts.step = int(broadcast_(step, group)[0])
    ts.generator.set_state(broadcast_(ts.generator.get_state(), group))
    return ts


# --- the 'model' axis --------------------------------------------------------

def channels_tp_spec(mesh: Mesh | None, channels: int,
                     index: int | None = None) -> slice:
    """The slice of a channel axis of `channels` that model index `index`
    (default: this rank's) computes: the counterpart of JAX's
    `channels_tp_spec` (channels sharded over 'model'). Every channel
    without a 'model' axis."""
    n = 1 if mesh is None else mesh.n_model
    if channels % n:
        raise ValueError(f"{channels} channels do not divide over "
                         f"{n} model ranks")
    if n == 1:
        return slice(0, channels)
    i = mesh.model_rank if index is None else index
    c = channels // n
    return slice(i * c, (i + 1) * c)


def _gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """The group's `t` concatenated along the last axis in rank order."""
    src = _on_backend(group, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1).to(t.device)


class _GatherChannels(torch.autograd.Function):
    """All-gather over the model group along channels. Backward: this
    rank's slice of the gradient, all-reduced first where each rank's
    gradient is a partial sum (`partial`)."""

    @staticmethod
    def forward(ctx, t, group, partial):
        ctx.group, ctx.partial, ctx.c = group, partial, t.shape[-1]
        return _gather_last(t, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[..., r * ctx.c:(r + 1) * ctx.c].contiguous(), None, None


CONSUMERS = ("sharded", "replicated")


def gather_channels(t: torch.Tensor, mesh: Mesh, *,
                    consumer: str) -> torch.Tensor:
    """This rank's channel slice `t` gathered over the 'model' axis into
    the whole channel axis, differentiable. The backward depends on what
    consumes the whole tensor, which the caller must say:

    - `consumer="sharded"`: a column-sharded op (each rank computes its
      slice of the output channels): each rank's gradient is a partial
      sum, so the backward all-reduces it over 'model', then slices;
    - `consumer="replicated"`: code that every model rank runs whole:
      each rank already holds the whole gradient, so the backward only
      slices (a sum would count it n_model times)."""
    if consumer not in CONSUMERS:
        raise ValueError(f"consumer must be one of {CONSUMERS}, "
                         f"got {consumer!r}")
    return _GatherChannels.apply(t, mesh.model_group, consumer == "sharded")


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def model_parallel_input(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A whole (replicated) tensor that a column-sharded op consumes: the
    identity, whose backward sums the model ranks' partial gradients."""
    return _SumGradients.apply(t, mesh.model_group)


def gather_model_slices(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's channel slice of a tensor without gradient (running
    statistics) gathered whole over the 'model' axis."""
    with torch.no_grad():
        return _gather_last(t, mesh.model_group)
