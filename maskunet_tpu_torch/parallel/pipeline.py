"""Pipeline parallelism: the 2-stage GPipe of the MaskAttn-UNet.

Counterpart of maskunet_tpu/parallel/pipeline.py. The model splits at its
encoder/decoder boundary (`models.maskattn_unet.encode` / `decode`), and a
fill-drain (GPipe) schedule runs the split over M microbatches:

    tick t:   stage 0 (encoder, device A) runs microbatch t
              stage 1 (decoder, device B) runs microbatch t-1
              the (x1, x2, x3, x4) skip payload moves A -> B

so M microbatches take M+1 ticks, and stage 0 computes microbatch t+1
while stage 1 decodes t. PyTorch runs the schedule in one process over
two devices, where JAX runs one SPMD program on a 2-device mesh:

- Stage 0's params and state are on A, stage 1's on B (differentiable
  copies where they live elsewhere, so gradients reach the originals).
  Each stage runs on a CUDA stream of its own, issued from a thread of
  its own (stage 1 on a worker thread), so the two really overlap on the
  card and on the host. A and B may be the same card: the stages then
  share it through their two streams. The payload's consumer stream
  waits on the producer's event and records the payload on itself, as
  `data/pipeline.py`'s Prefetcher does, so the allocator keeps it until
  stage 1 has read it.
- Each stage runs under `torch.utils.checkpoint` (non-reentrant), as
  JAX's `jax.checkpoint` around each tick: its activations are recomputed
  in the backward, so the forward kernels (K2) launch twice a microbatch.
- Only real work is run: the fill tick has no decoder and the drain tick
  no encoder, where JAX's SPMD program computes and discards both. So
  BatchNorm's running stats advance exactly once per microbatch, in
  microbatch order, as JAX's `gate` makes them (`ENCODER_STATE_KEYS`).
- Dropout's keep masks are drawn before the schedule, in microbatch order
  (for the global microbatch under a data axis, then this rank's rows),
  and enter the decoder as tensors, as JAX draws them outside its cond.
- Autograd across the two devices gives the backward: the gradients equal
  those of the sequential per-microbatch loop. The port has no
  collective-ordering hazard like JAX's (:176-189), where a cast inside a
  cond branch transposes to a psum that only one stage reaches: the
  payload moves by a device copy, not a collective, and no collective
  names the pipe axis. The only collectives are BatchNorm's all-reduces
  over a data axis (dp x pp), and each (stage, microbatch) issues them on
  a process group of its own, so the two stage threads, and the
  backward's device threads, never interleave two sequences on one group.

dp x pp (`make_dp_pipe_mesh`) is one process per data rank, each running
its own pair of stages on its rows of every microbatch, BatchNorm
all-reduced within each microbatch over the data axis.

By default both meshes take distinct devices and refuse a host with too
few cards, as JAX does. An explicit `devices=` list may name one device
twice (both stages on one card): a divergence from JAX, whose devices are
distinct; it is how the pipeline runs on a one-card host.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from maskunet_tpu_torch.models import maskattn_unet as model
from maskunet_tpu_torch.parallel import mesh as mesh_lib

PIPE_AXIS = "pipe"
N_STAGES = 2

# the state_dict prefixes of stage 0 (the encoder); the rest is stage 1's
ENCODER_STATE_KEYS = frozenset({
    "initial_conv", "downsample1", "downsample2", "downsample3",
    "bottom1", "bottom2", "bottom3", "self_attention1", "self_attention2",
    "self_attention3",
})


def stage_of(key: str) -> int:
    """The stage (0 encoder, 1 decoder) whose forward reads `key`."""
    return 0 if key.split(".", 1)[0] in ENCODER_STATE_KEYS else 1


@dataclasses.dataclass(frozen=True)
class PipeMesh:
    """This process's two stage devices, and the data axis of a dp x pp
    mesh (None: the plain ('pipe',) mesh)."""
    devices: tuple
    data: mesh_lib.Mesh | None = None
    # (stage, microbatch) -> the process group of its BatchNorm
    # all-reduces, made on first use (see the module docstring)
    _groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                      hash=False, repr=False)

    @property
    def axis_names(self) -> tuple:
        return ((PIPE_AXIS,) if self.data is None
                else (mesh_lib.DATA_AXIS, PIPE_AXIS))

    @property
    def shape(self) -> dict:
        shape = {PIPE_AXIS: len(self.devices)}
        if self.data is not None:
            shape = {mesh_lib.DATA_AXIS: self.data.n_data, **shape}
        return shape

    def stage_mesh(self, stage: int, micro: int) -> mesh_lib.Mesh | None:
        """The data mesh stage `stage` of microbatch `micro` normalises
        its BatchNorm over: its own process group."""
        group = mesh_lib.data_group(self.data)
        if group is None:
            return None
        key = (stage, micro)
        if key not in self._groups:
            self._groups[key] = dist.new_group(
                ranks=list(range(dist.get_world_size(group))),
                timeout=mesh_lib.DEFAULT_TIMEOUT)
        return mesh_lib.Mesh(self.data.devices, self._groups[key])


def _devices(devices, n: int) -> list[torch.device]:
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(min(torch.cuda.device_count(), n))]
    return [torch.device(d) for d in devices]


def make_pipe_mesh(devices=None) -> PipeMesh:
    """A 2-device mesh with the single `pipe` axis: the first two cards,
    or `devices` (which may name one device twice)."""
    devices = _devices(devices, N_STAGES)
    if len(devices) != N_STAGES:
        raise ValueError(f"pipeline mesh needs exactly {N_STAGES} devices, "
                         f"got {len(devices)}")
    return PipeMesh(tuple(devices))


def make_dp_pipe_mesh(n_data: int | None = None, devices=None) -> PipeMesh:
    """A ('data', 'pipe') mesh: n_data-way data parallelism x the 2-stage
    pipeline, `devices` (default: the host's cards) read as n_data pairs;
    data rank r (the process of rank r in the process group) runs its
    stages on pair r. A data axis of more than one rank needs the process
    group (`mesh.init_distributed`)."""
    devices = _devices(devices, torch.cuda.device_count())
    if n_data is None:
        n_data = len(devices) // N_STAGES
    if n_data * N_STAGES != len(devices):
        raise ValueError(f"dp x pp mesh {n_data}x{N_STAGES} != "
                         f"{len(devices)} devices")
    group = dist.group.WORLD if dist.is_initialized() else None
    if group is None and n_data > 1:
        raise ValueError(f"a dp x pp mesh of {n_data} data ranks needs one "
                         "process per rank: initialise the process group "
                         "(parallel.mesh.init_distributed)")
    if group is not None and dist.get_world_size() != n_data:
        raise ValueError(f"dp x pp mesh of {n_data} data ranks in a process "
                         f"group of {dist.get_world_size()}")
    pairs = [tuple(devices[2 * r:2 * r + 2]) for r in range(n_data)]
    data = mesh_lib.Mesh(tuple(p[0] for p in pairs), group)
    return PipeMesh(pairs[data.rank], data)


def validate_pipe_mesh(mesh) -> PipeMesh:
    """Check `mesh` carries the 2-wide `pipe` axis (alone, or beside a
    `data` axis for dp x pp)."""
    shape = dict(getattr(mesh, "shape", {}))
    if shape.get(PIPE_AXIS) != N_STAGES:
        raise ValueError(
            f"pipeline mesh needs a '{PIPE_AXIS}' axis of size {N_STAGES}, "
            f"got {shape} — build it with make_pipe_mesh() or "
            f"make_dp_pipe_mesh(n_data)")
    return mesh


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B/n_micro, ...]."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"n_micro={n_micro}")
    return x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])


class _Stage:
    """One stage's device and stream, and the context its work runs in:
    the caller's grad mode, on its device and stream."""

    def __init__(self, device: torch.device, grad: bool):
        self.device, self.grad = device, grad
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    @contextlib.contextmanager
    def context(self):
        with torch.set_grad_enabled(self.grad), contextlib.ExitStack() as st:
            if self.stream is not None:
                st.enter_context(torch.cuda.device(self.device))
                st.enter_context(torch.cuda.stream(self.stream))
            yield

    def wait_for_current(self):
        """This stage's stream waits for what the caller's stream issued
        (inputs, parameters, masks)."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def record(self):
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event


def _run(fn, *args):
    """`fn(*args)` under `torch.utils.checkpoint` where autograd records
    (the stage's activations recomputed in the backward), else directly."""
    if torch.is_grad_enabled():
        # no draw inside a stage (dropout masks come in), so no RNG state
        # to stash for the recompute
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def pipeline_apply(params: dict, state: dict, x_micro: torch.Tensor, *,
                   cfg: model.MaskAttnUNetConfig, mesh: PipeMesh,
                   masks: tuple | None = None, train: bool = False,
                   dropout_generator: torch.Generator | None = None,
                   mask_plans: tuple | None = None):
    """Pipelined forward over pre-split microbatches.

    x_micro: [M, mb, H, W, c_in] (`split_microbatches`), this rank's rows
    of each microbatch under a data axis. `masks` / `mask_plans` are sized
    for ONE global microbatch and shared by all of them (the cached-mask
    policy; pass fresh per-step masks for the 'fresh' one). Returns
    (ModelOutput with [M, mb, ...] leaves on stage 1's device, the new
    state, each tensor on the device of its entry in `state`)."""
    validate_pipe_mesh(mesh)
    use_dropout = train and cfg.dropout_rate > 0
    if use_dropout and dropout_generator is None:
        raise ValueError("dropout_generator required when train=True")
    n_micro, mb = x_micro.shape[:2]
    dev0, dev1 = mesh.devices
    data = mesh.data
    grad = torch.is_grad_enabled()
    enc, dec = _Stage(dev0, grad), _Stage(dev1, grad)

    # drawn before the schedule, in microbatch order: for the global
    # microbatch, then this rank's rows
    dropout = [None] * n_micro
    if use_dropout:
        n_data = 1 if mesh_lib.data_group(data) is None else data.n_data
        rows = mesh_lib.local_rows(data, mb * n_data)
        dropout = [tuple(m[rows].to(dev1) for m in model.draw_dropout_masks(
            dropout_generator, cfg, mb * n_data)) for _ in range(n_micro)]
    masks, mask_plans = mesh_lib.shard_masks(data, masks, mask_plans)
    p = [{k: v.to(d) for k, v in params.items() if stage_of(k) == s}
         for s, d in enumerate((dev0, dev1))]
    st = [{k: v.to(d) for k, v in state.items() if stage_of(k) == s}
          for s, d in enumerate((dev0, dev1))]
    m = [mesh_lib.move_tree(masks, d) for d in (dev0, dev1)]
    plans = [mesh_lib.move_tree(mask_plans, d) for d in (dev0, dev1)]
    x_micro = x_micro.to(dev0)
    for s in (enc, dec):
        s.wait_for_current()
    # the groups exist before either stage thread issues a collective
    stage_meshes = [[mesh.stage_mesh(s, t) for t in range(n_micro)]
                    for s in range(N_STAGES)]

    def encode(t):
        with enc.context():
            def fn(x, state=st[0]):
                return model.encode(p[0], state, x, cfg=cfg, masks=m[0],
                                    train=train, mask_plans=plans[0],
                                    mesh=stage_meshes[0][t])
            skips, new = _run(fn, x_micro[t])
            if train:
                st[0] = {**st[0], **new}
            return skips, enc.record()

    def decode(t, skips, ready):
        with dec.context():
            if ready is not None:
                dec.stream.wait_event(ready)
            # to stage 1's device (the same tensors on a shared card),
            # recorded on stage 1's stream: the allocator keeps them until
            # its kernels have read them
            skips = tuple(s.to(dev1, non_blocking=True) for s in skips)
            if dec.stream is not None:
                for s in skips:
                    s.record_stream(dec.stream)

            def fn(*payload, state=st[1]):
                return model.decode(p[1], state, payload, cfg=cfg,
                                    masks=m[1], train=train,
                                    mask_plans=plans[1],
                                    dropout_masks=dropout[t],
                                    mesh=stage_meshes[1][t])
            out, new = _run(fn, *skips)
            if train:
                st[1] = {**st[1], **new}
            return out

    # every payload is held until both streams have been waited for: a
    # copy to another card reads it on stage 1's stream
    outs, payloads = [], []
    with concurrent.futures.ThreadPoolExecutor(1) as worker:
        for t in range(n_micro + 1):
            # stage 1 decodes microbatch t-1 on the worker thread while
            # stage 0 encodes microbatch t on this one
            pending = (worker.submit(decode, t - 1, *payloads[-1])
                       if t > 0 else None)
            if t < n_micro:
                payloads.append(encode(t))
            if pending is not None:
                outs.append(pending.result())
    for s in (enc, dec):
        if s.stream is not None:
            torch.cuda.current_stream(s.device).wait_stream(s.stream)
    if dec.stream is not None:   # stage 1's outputs, read on this stream
        for o in outs:
            for t in o:
                if t is not None:
                    t.record_stream(torch.cuda.current_stream(dev1))
    del payloads
    out = model.ModelOutput(*(
        None if out0 is None else torch.stack([o[i] for o in outs])
        for i, out0 in enumerate(outs[0])))
    new_state = {k: v.to(state[k].device) for k, v in {**st[0], **st[1]}
                 .items()}
    return out, new_state
