"""Checkpoints: full-state save and restore, warm start, async saves.

Counterpart of maskunet_tpu/core/checkpoint.py, in the JAX package's own
format, both ways: a file this module writes restores in the JAX package,
and one the JAX package writes restores here. The file is
`{name}_{tag}.msgpack`, the msgpack that flax's `to_bytes` makes of the
JAX `TrainState` (`core/_msgpack.py` reads and writes it without flax):

- ``step``: int32 scalar;
- ``params``, ``model_state``: the JAX package's trees (`utils.jax_weights`
  `to_jax` / `from_jax`: the same leaves in JAX's layouts and names);
- ``opt_state``: optax's `adamw` state, ``{"0": {"count", "mu", "nu"},
  "1": {}, "2": {}}``, with ``"2": {"count"}`` under an lr schedule. torch
  AdamW's per-parameter ``exp_avg`` / ``exp_avg_sq`` / ``step`` are mu / nu
  / count; the LambdaLR's update count is the schedule's count;
- ``rng``: the port's dropout generator state (uint8). A JAX checkpoint
  holds a PRNG key there (uint32 key data); restoring it seeds the
  generator from the key data's first 8 bytes. The two packages' dropout
  streams differ anyway, so a resumed JAX run draws other dropout masks
  here than in JAX (and JAX's full `restore` of a file written here fails
  on this leaf; its `restore_inference` ignores it);
- ``masks``: the cached attention masks, ``{"0": ..., "5": ...}``.

Writes are atomic (tmp + `os.replace`). `CheckpointManager` saves
asynchronously: the snapshot is a device-side copy (one flat buffer a
group of tensors), taken on the caller's stream before the next step's
`optimizer.step()` overwrites the parameters and moments in place (the
port's form of JAX's donation hazard); the background thread copies it to
the host, encodes and writes it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from maskunet_tpu_torch.core import _msgpack
from maskunet_tpu_torch.utils import jax_weights


def _import_meta_path(workdir: str, name: str) -> str:
    return os.path.join(workdir, f"{name}_import_meta.json")


def write_import_meta(workdir: str, name: str, meta: dict) -> str:
    """Record checkpoint provenance (e.g. a torch import's
    attn_output_layout) next to the checkpoint files, so inference
    commands can resolve model-semantics options automatically."""
    path = _import_meta_path(workdir, name)
    os.makedirs(workdir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path)
    return path


def read_import_meta(workdir: str, name: str) -> dict | None:
    """The sidecar written by `write_import_meta`, or None."""
    path = _import_meta_path(workdir, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _heads(params: dict) -> SimpleNamespace:
    """The heads a flat parameter dict has, as `jax_weights.mapping` asks."""
    return SimpleNamespace(
        embed_dim=int("embedding_head.0.weight" in params),
        with_boundary_head="boundary_head.0.weight" in params)


def _sorted(tree):
    """Keys in sorted order at every level, as `jax.device_get` leaves the
    JAX state's dicts before flax writes them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


@dataclasses.dataclass
class _Packed:
    """Same-dtype tensors cloned into one flat buffer by one `torch.cat`
    (one launch for a few hundred tensors; a clone each would cost the
    caller a few hundred launches)."""
    names: list
    shapes: list
    flat: torch.Tensor

    @classmethod
    def of(cls, tensors: dict) -> "_Packed":
        flat = torch.cat([t.detach().reshape(-1) for t in tensors.values()])
        return cls(list(tensors), [t.shape for t in tensors.values()], flat)

    def unpack(self) -> dict:
        sizes = [s.numel() for s in self.shapes]
        return {k: v.view(s) for k, v, s in
                zip(self.names, self.flat.split(sizes), self.shapes)}


@dataclasses.dataclass
class Snapshot:
    """What a checkpoint holds, detached from the live state: copies on
    the state's device that no later step touches."""
    step: int
    params: _Packed
    model_state: _Packed
    exp_avg: _Packed
    exp_avg_sq: _Packed
    count: int                      # AdamW's updates (optax's count)
    schedule_count: int | None      # the LambdaLR's, under a schedule
    rng: torch.Tensor               # the generator's state, on the host
    masks: tuple | None


def _adam_count(optimizer: torch.optim.Optimizer) -> int:
    for st in optimizer.state.values():
        if "step" in st:
            return int(st["step"])
    return 0


def snapshot(ts) -> Snapshot:
    """Copies of everything `ts` would save, queued on the current stream:
    a later in-place update on that stream cannot reach them."""
    moments = {}
    for m in ("exp_avg", "exp_avg_sq"):
        moments[m] = _Packed.of({
            k: ts.optimizer.state[p][m] if m in ts.optimizer.state.get(p, {})
            else torch.zeros_like(p.detach()) for k, p in ts.params.items()})
    return Snapshot(
        step=int(ts.step),
        params=_Packed.of(ts.params),
        model_state=_Packed.of(ts.model_state),
        count=_adam_count(ts.optimizer),
        schedule_count=(None if ts.scheduler is None
                        else int(ts.scheduler.last_epoch)),
        rng=ts.generator.get_state(),
        masks=(None if ts.masks is None
               else tuple(m.detach().clone() for m in ts.masks)),
        **moments)


def _to_host(packs: list) -> list:
    """The packs' buffers on the host. From the card: pinned copies on a
    stream of their own (they do not queue behind the caller's later
    steps), one wait for all of them."""
    if not packs[0].flat.is_cuda:
        return packs
    stream = torch.cuda.Stream(packs[0].flat.device)
    with torch.cuda.stream(stream):
        host = [dataclasses.replace(p, flat=torch.empty(
            p.flat.shape, dtype=p.flat.dtype, pin_memory=True).copy_(
                p.flat, non_blocking=True)) for p in packs]
    stream.synchronize()
    return host


def to_tree(snap: Snapshot) -> dict:
    """The JAX `TrainState`'s state dict (field order, sorted subtrees), as
    numpy arrays on the host."""
    params, state, mu, nu = (p.unpack() for p in _to_host(
        [snap.params, snap.model_state, snap.exp_avg, snap.exp_avg_sq]))
    heads = _heads(params)
    params, mstate = jax_weights.to_jax(params, state, heads)
    mu = jax_weights.to_jax(mu, state, heads)[0]
    nu = jax_weights.to_jax(nu, state, heads)[0]
    scalar = lambda n: np.asarray(n, np.int32)   # noqa: E731
    return {
        "step": scalar(snap.step),
        "params": _sorted(params),
        "model_state": _sorted(mstate),
        "opt_state": {
            "0": {"count": scalar(snap.count), "mu": _sorted(mu),
                  "nu": _sorted(nu)},
            "1": {},
            "2": ({} if snap.schedule_count is None
                  else {"count": scalar(snap.schedule_count)})},
        "rng": snap.rng.cpu().numpy(),
        "masks": (None if snap.masks is None
                  else tuple(m.cpu().numpy() for m in snap.masks)),
    }


def _write(path: str, tree: dict) -> None:
    chunks = _msgpack.pack_chunks(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            f.writelines(chunks)
    except BaseException:
        os.remove(tmp)   # no torn tmp file left behind (a full disk)
        raise
    os.replace(tmp, path)


def save(path: str, ts) -> None:
    """Atomically write the state `ts` to `path` (synchronous)."""
    _write(path, to_tree(snapshot(ts)))


def restore_raw(path: str) -> dict:
    """The file as a nested dict of numpy arrays, without a template (for
    warm starts across models whose structures differ)."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    return _msgpack.unpackb(buf)


def _host(tensors: dict) -> dict:
    return {k: v.cpu() for k, v in tensors.items()}


def _port_tree(tree: dict, mstate_tree: dict, heads) -> dict:
    """A JAX params-shaped tree as the port's flat dict of f32 tensors."""
    return jax_weights.from_jax(tree, mstate_tree, heads)[0]


def _load_weights(ts, raw: dict) -> None:
    params, mstate = jax_weights.from_jax(raw["params"], raw["model_state"],
                                          _heads(ts.params))
    if params.keys() != ts.params.keys():
        raise ValueError("checkpoint parameters differ from the state's")
    with torch.no_grad():
        for k, p in ts.params.items():
            if p.shape != params[k].shape:
                raise ValueError(f"{k}: checkpoint shape "
                                 f"{tuple(params[k].shape)} against "
                                 f"{tuple(p.shape)}")
            p.copy_(params[k])   # in place: the optimizer holds `p`
    dev = next(iter(ts.params.values())).device
    ts.model_state = {k: v.to(dev) for k, v in mstate.items()}
    ts.step = int(raw.get("step", ts.step))
    if ts.masks is not None and raw.get("masks") is not None:
        # copies: a view would keep the whole file's buffer alive
        ts.masks = tuple(torch.from_numpy(np.array(raw["masks"][str(i)]))
                         .to(dev) for i in range(len(raw["masks"])))


def _seed_from(rng: np.ndarray) -> int:
    return int.from_bytes(rng.tobytes()[:8], "little") % 2 ** 63


def _load_optimizer(ts, raw: dict) -> None:
    adam = raw["opt_state"]["0"]
    heads = _heads(ts.params)
    mu = _port_tree(adam["mu"], raw["model_state"], heads)
    nu = _port_tree(adam["nu"], raw["model_state"], heads)
    count = int(adam["count"])
    keys = list(ts.params)
    state = ts.optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(ts.optimizer.param_groups[0]
                                            ["params"])}
    state["state"] = {
        index[id(ts.params[k])]: {"step": torch.tensor(float(count)),
                                  "exp_avg": mu[k], "exp_avg_sq": nu[k]}
        for k in keys}
    ts.optimizer.load_state_dict(state)
    if ts.scheduler is not None:
        sched = raw["opt_state"].get("2") or {}
        n = int(sched.get("count", count))
        ts.scheduler = torch.optim.lr_scheduler.LambdaLR(
            ts.optimizer, ts.scheduler.lr_lambdas[0], last_epoch=n - 1)


def restore(path: str, template):
    """The whole state from `path` into `template` (a `TrainState` of the
    same model): parameters copied in place, BN statistics, masks, step,
    AdamW's moments and count, the schedule's count and the generator.
    Returns `template`."""
    raw = restore_raw(path)
    _load_weights(template, raw)
    _load_optimizer(template, raw)
    rng = np.asarray(raw["rng"])
    own = template.generator.get_state()
    if rng.dtype == np.uint8 and rng.size == own.numel():
        template.generator.set_state(torch.from_numpy(rng.copy()))
    else:   # a JAX key (or another device's generator)
        template.generator.manual_seed(_seed_from(rng))
    return template


def restore_inference(path: str, template):
    """Params, BN statistics, masks and step from `path` into `template`;
    the optimizer state and generator are left as they are (inference
    needs neither, and the file may come from another optimizer set-up).
    Returns `template`."""
    _load_weights(template, restore_raw(path))
    return template


def transfer_params(init_params: dict, ckpt_params: dict,
                    drop_prefixes: tuple[str, ...] = ()
                    ) -> tuple[dict, list]:
    """Warm start on JAX-layout trees: take every checkpoint leaf whose
    path and shape match the freshly initialized params; keep the fresh
    init for dropped prefixes, missing keys, or shape mismatches (e.g. a
    different c_out head). Returns (merged_params, skipped_paths)."""
    skipped: list = []

    def merge(node, ckpt, path):
        if isinstance(node, dict):
            return {k: merge(node[k],
                             ckpt.get(k) if isinstance(ckpt, dict) else None,
                             path + (str(k),))
                    for k in sorted(node)}
        if any(path[0] == d or "/".join(path).startswith(d)
               for d in drop_prefixes):
            skipped.append(path)
            return node
        if ckpt is None or isinstance(ckpt, dict) \
                or np.shape(ckpt) != np.shape(node):
            skipped.append(path)
            return node
        return ckpt

    return merge(init_params, ckpt_params, ()), skipped


def warm_start(ts, ckpt_params: dict, drop_prefixes: tuple[str, ...] = ()
               ) -> list:
    """`transfer_params` applied to `ts`'s parameters in place; returns
    the skipped paths."""
    heads = _heads(ts.params)
    state = _host(ts.model_state)
    tree, mstate = jax_weights.to_jax(_host(ts.params), state, heads)
    merged, skipped = transfer_params(tree, ckpt_params, drop_prefixes)
    new = _port_tree(merged, mstate, heads)
    with torch.no_grad():
        for k, p in ts.params.items():
            p.copy_(new[k])
    return skipped


class CheckpointManager:
    """best / latest retention, with the JAX manager's semantics.

    Saves are asynchronous: `snapshot` copies the state on the device
    (~300 MB at full width: four `torch.cat` launches and a clone of each
    mask, queued on the caller's stream), then a background thread waits
    for the copies, brings them to the host on a stream of its own,
    encodes and writes atomically. The thread's Python work is small (a
    few thousand small objects), so it takes little of the interpreter
    from the caller's dispatch. One save per tag is in flight at a time;
    `wait()` joins every pending write and re-raises the first failure.
    `blocked_s` sums the seconds `save_*` held the caller (the copies'
    launches, the join of the tag's previous save)."""

    def __init__(self, directory: str, name: str = "checkpoint"):
        self.directory = directory
        self.name = name
        self.blocked_s = 0.0
        self._pending: dict[str, threading.Thread] = {}
        self._errors: list[tuple[str, BaseException]] = []
        os.makedirs(directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{self.name}_{tag}.msgpack")

    def _save_thread(self, path: str, tag: str, snap: Snapshot,
                     ready: torch.cuda.Event | None) -> None:
        try:
            if ready is not None:
                ready.synchronize()    # the copies are complete
            _write(path, to_tree(snap))
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            self._errors.append((tag, e))

    def _save(self, tag: str, ts) -> str:
        t0 = time.perf_counter()
        path = self._path(tag)
        snap = snapshot(ts)
        ready = None
        if snap.params.flat.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        prev = self._pending.get(tag)
        if prev is not None:
            prev.join()
        self._raise_pending_errors()
        t = threading.Thread(target=self._save_thread,
                             args=(path, tag, snap, ready), daemon=True)
        t.start()
        self._pending[tag] = t
        self.blocked_s += time.perf_counter() - t0
        return path

    def _raise_pending_errors(self) -> None:
        if self._errors:
            tag, err = self._errors[0]
            self._errors.clear()
            raise RuntimeError(
                f"async checkpoint save '{tag}' failed — no durable "
                f"checkpoint was written") from err

    def wait(self) -> None:
        """Join all in-flight writes; re-raises the first save failure."""
        for t in self._pending.values():
            t.join()
        self._pending.clear()
        self._raise_pending_errors()

    def save_best(self, ts) -> str:
        return self._save("best", ts)

    def save_latest(self, ts) -> str:
        return self._save("latest", ts)

    def restore(self, template, tag: str = "latest"):
        self.wait()
        return restore(self._path(tag), template)

    def has(self, tag: str = "latest") -> bool:
        self.wait()
        return os.path.exists(self._path(tag))
