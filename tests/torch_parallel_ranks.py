"""Spawned ranks for the port's data-parallel tests (not collected).

`spawn(target, n, *args)` starts n processes, each a rank of a gloo
process group met at a free local port, runs `target(rank, *args)` in
each and returns their results in rank order. Every rank pins torch to
one thread (the suite runs six workers side by side), every group has a
timeout, and the parent waits for the ranks with a deadline: a rank that
fails or misses it fails the test instead of hanging the suite. The
targets below compare the port's data-parallel paths with its
one-process paths inside rank 0 and return numbers only (numpy arrays
and floats), since torch tensors do not outlive the spawned process.

Imports no jax: the card's machine runs the card tests with these ranks.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

DEADLINE_S = 240.0
IMG, NC, B = 16, 5, 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(target, n: int, *args, deadline: float = DEADLINE_S,
          backend: str = "gloo") -> list:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(target, r, n, port, backend, q,
                                             args), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    results, errors = {}, []
    try:
        for _ in range(n):
            rank, err, out = q.get(timeout=max(1.0, end - time.monotonic()))
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                results[rank] = out
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(n)) - set(results))} "
                      f"missed the {deadline:.0f} s deadline")
    finally:
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5)
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(n)]


def _rank(target, rank, n, port, backend, q, args) -> None:
    import torch.distributed as dist

    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    try:
        mesh_lib.init_distributed(f"localhost:{port}", n, rank, backend,
                                  timeout=datetime.timedelta(seconds=120))
        q.put((rank, None, target(rank, *args)))
    except BaseException:  # noqa: BLE001 — reported by the parent
        q.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --- the scenarios: one global batch and state, built alike everywhere ---

class SGD:
    """An optimizer factory as `train.loop.AdamW`: plain SGD, whose update
    is the gradient itself (tests/test_sharding.py compares DP with one
    device after one SGD update for that reason)."""
    schedule = None

    def __init__(self, lr: float = 0.1):
        self.lr = lr

    def __call__(self, params):
        return torch.optim.SGD(params, lr=self.lr)

    def scheduler(self, optimizer):
        return None


SCENARIOS = {
    # name: (cfg kwargs, task kwargs, grad_accum, pipe microbatches)
    "cached": ({}, {}, 1, 1),
    "fresh_triplet": ({}, dict(mask_policy="fresh", ce_weight=0.9,
                              triplet_weight=0.1), 1, 1),
    "embed_accum": (dict(embed_dim=4), dict(
        ignore_index=255, triplet_weight=0.5, triplet_features="embeddings",
        triplet_ignore_label=255), 2, 1),
    "dp_pp": ({}, dict(ce_weight=0.9, triplet_weight=0.1), 1, 2),
}


def scenario(name: str, dtype: str = "float32", device="cpu"):
    """(cfg, task, fresh state, global batch, grad_accum, microbatches):
    dropout 0.3, masks sized for the global model-forward microbatch."""
    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.train import step as tstep
    cfg_kw, task_kw, accum, micro = SCENARIOS[name]
    cfg = mu.MaskAttnUNetConfig(c_out=NC, img_size=IMG, compute_dtype=dtype,
                                **cfg_kw)
    task = dataclasses.replace(tstep.TaskConfig(), **task_kw)
    gen = torch.Generator().manual_seed(0)
    params, mstate = mu.init(gen, cfg)
    masks = mu.make_attention_masks(gen, B // (accum * micro), IMG)
    ts = state_lib.create(torch.Generator(device=device).manual_seed(1),
                          {k: v.to(device) for k, v in params.items()},
                          {k: v.to(device) for k, v in mstate.items()},
                          SGD(), tuple(m.to(device) for m in masks))
    rng = np.random.default_rng(2)
    label = rng.integers(0, NC, (B, IMG, IMG))
    if task.ignore_index is not None:
        label[:, :3] = task.ignore_index
    batch = {"image": rng.standard_normal((B, IMG, IMG, 3)).astype(
                 np.float32),
             "label": label,
             "instance": rng.integers(0, 4, (B, IMG, IMG))}
    return cfg, task, ts, batch, accum, micro


def _step(name, device, mesh=None, pipe_devices=None, dtype="float32"):
    """One train step of scenario `name`: (metrics, state) on `device`,
    data-parallel over `mesh` or pipelined over `pipe_devices` (a dp x pp
    mesh when a process group is up)."""
    import torch.distributed as dist

    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.parallel import pipeline as pp
    from maskunet_tpu_torch.train import step as tstep
    cfg, task, ts, batch, accum, micro = scenario(name, dtype, device)
    pipe = None
    if micro > 1:
        if dist.is_initialized() and mesh is not None:
            pipe = pp.make_dp_pipe_mesh(mesh.n_data,
                                        devices=list(pipe_devices) * 2)
        else:
            pipe = pp.make_pipe_mesh(devices=pipe_devices)
        mesh = None
    mesh_lib.put_replicated(mesh if pipe is None else pipe.data, ts)
    step = tstep.make_train_step(
        cfg, task, grad_accum=accum,
        mask_plans=mu.precompute_mask_plans(ts.masks), device=device,
        mesh=mesh, pipe_mesh=pipe, pipe_microbatches=micro)
    ts, metrics = step(ts, batch)
    return metrics, ts


def _numbers(metrics, ts) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().cpu().double().numpy()
                       for k, v in ts.params.items()},
            "state": {k: v.cpu().double().numpy()
                      for k, v in ts.model_state.items()},
            "generator": ts.generator.get_state().numpy()}


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def dp_step(rank: int, name: str, device: str = "cpu",
            dtype: str = "float32") -> dict:
    """The data-parallel step of scenario `name` on this rank; rank 0 also
    runs the one-process step on the global batch and returns both's
    metrics and the largest differences of the updated params and BN
    stats. Every rank returns its params' sums and its generator state
    (the ranks must agree exactly: the same update from the same
    all-reduced gradients, the same draws)."""
    import torch.distributed as dist

    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    n = dist.get_world_size()
    mesh = mesh_lib.make_mesh(n, devices=[device] * n)
    got = _numbers(*_step(name, device, mesh, [device] * 2, dtype))
    out = {"sums": np.array([v.sum() for v in got["params"].values()]),
           "generator": got["generator"], "metrics": got["metrics"]}
    if rank == 0:
        want = _numbers(*_step(name, device, None, [device] * 2, dtype))
        out.update(want_metrics=want["metrics"],
                   want_generator=want["generator"],
                   params_diff=_max_diff(got["params"], want["params"]),
                   state_diff=_max_diff(got["state"], want["state"]),
                   params_cos=min(
                       float(got["params"][k].ravel()
                             @ want["params"][k].ravel()
                             / max(np.linalg.norm(got["params"][k])
                                   * np.linalg.norm(want["params"][k]),
                                   1e-300))
                       for k in got["params"]))
    return out


def dp_steps(rank: int, names: list) -> dict:
    """`dp_step` of each scenario in `names`, in this one rank."""
    return {name: dp_step(rank, name) for name in names}


def dp_batchnorm(rank: int) -> dict:
    """Cross-replica `batchnorm_train` on this rank's rows against the
    one-process call on the global batch, f32 and bf16 inputs: the
    output rows, the new running stats, and the gradients of a fixed
    weighting of the output (x's rows; weight and bias all-reduced)."""
    from maskunet_tpu_torch.core import layers
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(2, devices=["cpu", "cpu"])
    rows = mesh_lib.local_rows(mesh, 4)
    g = torch.Generator().manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(4, 6, 6, 8, generator=g) * 3 + 1).to(dtype)
        w = torch.randn(4, 6, 6, 8, generator=g)
        weight = torch.rand(8, generator=g) + 0.5
        bias = torch.randn(8, generator=g)
        rm, rv = torch.randn(8, generator=g), torch.rand(8, generator=g) + 1

        def run(xx, ww, group):
            xx = xx.clone().requires_grad_(True)
            wt = weight.clone().requires_grad_(True)
            bs = bias.clone().requires_grad_(True)
            y, m, v = layers.batchnorm_train(wt, bs, rm, rv, xx, group=group)
            gx, gw, gb = torch.autograd.grad((y.float() * ww).sum(),
                                             (xx, wt, bs))
            gw = mesh_lib.all_reduce_(gw.clone(), group)
            gb = mesh_lib.all_reduce_(gb.clone(), group)
            return [t.detach().float().numpy() for t in (y, m, v, gx, gw,
                                                           gb)]

        got = run(x[rows], w[rows], mesh.group)
        want = run(x, w, None)
        want[0], want[3] = want[0][rows], want[3][rows]
        out[str(dtype)] = [float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                           1e-30))
                           for a, b in zip(got, want)]
    return out


def dp_forward(rank: int) -> dict:
    """The train-mode forward of the 'cached' scenario without dropout on
    this rank's rows, cross-replica BatchNorm: the logits gathered over
    the ranks and the new running stats (for a comparison with JAX's
    forward on the global batch)."""
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    cfg, _, ts, batch, _, _ = scenario("cached")
    cfg = dataclasses.replace(cfg, dropout_rate=0.0)
    mesh = mesh_lib.make_mesh(2, devices=["cpu", "cpu"])
    local = mesh_lib.shard_batch(mesh, {"image": torch.from_numpy(
        batch["image"])})
    masks, plans = mesh_lib.shard_masks(mesh, ts.masks)
    with torch.no_grad():
        out, state = mu.apply(ts.params, ts.model_state, local["image"],
                              cfg=cfg, masks=masks, train=True, mesh=mesh)
    return {"logits": mesh_lib.all_gather_rows(out.semantic, mesh).numpy(),
            "state": {k: v.numpy() for k, v in state.items()}}


def dp_eval(rank: int) -> dict:
    """The eval step over the mesh on a batch with a padded row against the
    one-process eval step: metrics, and the gathered pred and prob."""
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.train import step as tstep
    cfg, task, ts, batch, _, _ = scenario("fresh_triplet")
    batch["valid"] = np.array([True, True, True, False])
    mesh = mesh_lib.make_mesh(2, devices=["cpu", "cpu"])
    plans = mu.precompute_mask_plans(ts.masks)
    got = tstep.make_eval_step(cfg, task, device="cpu", mesh=mesh)(
        ts, dict(batch), plans)
    gathered = {k: mesh_lib.all_gather_rows(got[k], mesh).numpy()
                for k in ("pred", "prob")}
    out = {"metrics": {k: float(v) for k, v in got["metrics"].items()},
           **gathered}
    if rank == 0:
        want = tstep.make_eval_step(cfg, task, device="cpu")(
            ts, dict(batch), plans)
        out["want_metrics"] = {k: float(v)
                               for k, v in want["metrics"].items()}
        out["want_pred"] = want["pred"].numpy()
        out["want_prob"] = want["prob"].numpy()
    return out


def eval_recipes():
    """A 16 px synthetic panoptic recipe (connected-component instances)
    and a synthetic city_instance one (embeddings and DBSCAN), batch 2."""
    from maskunet_tpu_torch.tasks import recipes
    small = dict(img_size=16, batch_size=2)
    return (dataclasses.replace(recipes.get("synthetic_panoptic"),
                                eval_max_queries=(10, 20), **small),
            dataclasses.replace(recipes.get("city_instance"),
                                dataset="synthetic", num_classes=5,
                                eval_max_queries=(10, 20), **small))


def dp_evaluators(rank: int) -> dict:
    """`evaluate_panoptic` and `evaluate_instances` with the mesh, and on
    rank 0 without one, on seeded states (2 validation batches each)."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.tasks import evaluators
    from maskunet_tpu_torch.train import loop
    mesh = mesh_lib.make_mesh(2, devices=["cpu", "cpu"])
    pan, inst = eval_recipes()
    out = {}
    for name, recipe, fn in (("panoptic", pan, evaluators.evaluate_panoptic),
                             ("instances", inst,
                              evaluators.evaluate_instances)):
        cfg = loop.model_config(recipe, recipe.num_classes)
        ts = loop.setup_state(recipe, cfg, loop.make_optimizer(recipe),
                              device="cpu")
        out[name] = fn(recipe, None, ts, max_batches=2, device="cpu",
                       mesh=mesh)
        if rank == 0:
            out["want_" + name] = fn(recipe, None, ts, max_batches=2,
                                     device="cpu")
    return out


# --- ring attention: the 'seq' axis ---------------------------------------

def ring_attention(rank: int, cases: dict) -> dict:
    """Each case {params, tokens, mask, grads} (numpy, global) through the
    port's `ring_spatial_attention` on this rank's token shard: the output
    shard, and with `grads` the shard's gradient of the global sum of
    squares and the parameters' gradients summed over the ring. Also
    "permute": what `ring_permute` brings this rank, and the gradient it
    sends back when each rank weights what it received by its rank + 1."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.parallel import ring_attention as ring
    import torch.distributed as dist
    n = dist.get_world_size()
    mesh = mesh_lib.make_mesh(n, devices=["cpu"] * n)
    out = {}
    for name, case in cases.items():
        params = {k: torch.from_numpy(v).requires_grad_(case["grads"])
                  for k, v in case["params"].items()}
        tokens = mesh_lib.shard_tokens(mesh, torch.from_numpy(
            case["tokens"])).clone().requires_grad_(case["grads"])
        mask = (None if case["mask"] is None else mesh_lib.shard_tokens(
            mesh, torch.from_numpy(case["mask"])))
        y = ring.ring_spatial_attention(params, tokens, mask, mesh=mesh)
        got = {"out": y.detach().numpy()}
        if case["grads"]:
            keys = list(params)
            grads = torch.autograd.grad(y.square().sum(),
                                        [tokens] + [params[k] for k in keys])
            got["tokens"] = grads[0].numpy()
            got["params"] = {k: mesh_lib.all_reduce_(g.clone(),
                                                     mesh.group).numpy()
                             for k, g in zip(keys, grads[1:])}
        out[name] = got
    x = torch.tensor([float(rank)], requires_grad=True)
    y = ring.ring_permute(x, mesh.group)
    (g,) = torch.autograd.grad((y * (rank + 1)).sum(), [x])
    out["permute"] = (float(y), float(g))
    return out


# --- tensor parallelism: a (data, model) mesh ----------------------------

TP_SHAPE = (2, 2)       # (n_data, n_model)
TP_BATCH = 8


def tp_scenario(remat: bool = False):
    """tests/test_sharding.py:21-37 in the port: c_out 4, 16 px, dense
    attention, dropout 0, SGD 1e-2 (AdamW's first update is ~sign(grad)),
    masks and a global batch of 8: (cfg, task, fresh state, batch)."""
    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.train import step as tstep
    cfg = mu.MaskAttnUNetConfig(c_out=4, img_size=16, attn_impl="dense",
                                dropout_rate=0.0, remat_attention=remat)
    gen = torch.Generator().manual_seed(0)
    params, mstate = mu.init(gen, cfg)
    masks = mu.make_attention_masks(gen, TP_BATCH, cfg.img_size)
    ts = state_lib.create(torch.Generator().manual_seed(1), params, mstate,
                          SGD(1e-2), masks)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((TP_BATCH, 16, 16, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 4, (TP_BATCH, 16, 16))}
    return cfg, tstep.TaskConfig(), ts, batch


def _tp_gathers(mesh) -> dict:
    """The two backwards of `gather_channels` and that of
    `model_parallel_input`, each against autograd on the whole tensors in
    this process: x [2, 3, 3, 8] (8 channels over the model axis) into
    z = x @ w [8, 6] weighted by g; a column-sharded consumer computes
    its slice of z's 6 columns, a replicated one all of them. Returns the
    largest differences of x's gradients (this rank's slice, or whole)."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    gen = torch.Generator().manual_seed(3)
    x, w, g = (torch.randn(*s, generator=gen)
               for s in ((2, 3, 3, 8), (8, 6), (2, 3, 3, 6)))
    xs, cols = (mesh_lib.channels_tp_spec(mesh, c) for c in (8, 6))
    whole = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(((whole @ w) * g).sum(), [whole])
    out = {}
    for consumer in mesh_lib.CONSUMERS:
        local = x[..., xs].clone().requires_grad_(True)
        y = mesh_lib.gather_channels(local, mesh, consumer=consumer)
        c = cols if consumer == "sharded" else slice(None)
        (got,) = torch.autograd.grad(((y @ w[:, c]) * g[..., c]).sum(),
                                     [local])
        out[consumer] = float((got - want[..., xs]).abs().max())
    whole_in = x.clone().requires_grad_(True)
    y = mesh_lib.model_parallel_input(whole_in, mesh)
    (got,) = torch.autograd.grad(((y @ w[:, cols]) * g[..., cols]).sum(),
                                 [whole_in])
    out["model_parallel_input"] = float((got - want).abs().max())
    return out


def tp_all(rank: int, workdir: str) -> dict:
    """Every tensor-parallel check on a 2x2 (data, model) mesh of the 4
    ranks: the mesh's sizes, refusals and rank mapping; the gathers'
    backwards; the TP train step (with `remat_attention`) and, on rank 0,
    the one-process step on the global batch; the TP eval forward's
    logits gathered over 'data' (for JAX's `mu.apply`); the TP eval step,
    `loop.evaluate` and `evaluate_panoptic` against one process; and
    `loop.train` for one step into `workdir`."""
    import torch.distributed as dist

    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.tasks import evaluators
    from maskunet_tpu_torch.tasks import recipes
    from maskunet_tpu_torch.train import loop
    from maskunet_tpu_torch.train import step as tstep
    n_data, n_model = TP_SHAPE
    out = {"refusals": []}
    for bad in (dict(n_data=2, n_model=2, devices=["cpu"] * 3),
                dict(n_data=1, n_model=2, devices=["cpu"] * 2)):
        try:
            mesh_lib.make_mesh(**bad)
        except ValueError as e:
            out["refusals"].append(str(e))
    mesh = mesh_lib.make_mesh(n_data, n_model=n_model,
                              devices=["cpu"] * (n_data * n_model))
    out.update(global_rank=dist.get_rank(), data_index=mesh.rank,
               model_index=mesh.model_rank, lead=mesh_lib.is_lead(mesh),
               shape=mesh.shape, device=str(mesh.device),
               gathers=_tp_gathers(mesh))

    # the train step: TP (remat) against one process (rank 0)
    cfg, task, ts, batch = tp_scenario(remat=True)
    mesh_lib.put_replicated(mesh, ts)
    step = tstep.make_train_step(
        cfg, task, mask_plans=mu.precompute_mask_plans(ts.masks),
        device="cpu", mesh=mesh)
    ts, metrics = step(ts, batch)
    got = _numbers(metrics, ts)
    out.update(metrics=got["metrics"],
               sums=np.array([v.sum() for v in got["params"].values()]))
    if rank == 0:
        cfg1, _, ref, _ = tp_scenario()
        ref, metrics = tstep.make_train_step(
            cfg1, task, mask_plans=mu.precompute_mask_plans(ref.masks),
            device="cpu")(ref, batch)
        want = _numbers(metrics, ref)
        out.update(
            want_metrics=want["metrics"],
            params_diff=_max_diff(got["params"], want["params"]),
            bottom2_diff=_max_diff(
                *({k: v for k, v in d.items() if k.startswith("bottom2.")}
                  for d in (got["params"], want["params"]))),
            state_diff=_max_diff(got["state"], want["state"]))

    # the eval forward, the eval step, `evaluate` and an evaluator
    cfg, task, ts, batch = tp_scenario()
    local = mesh_lib.shard_batch(mesh, {"image": torch.from_numpy(
        batch["image"])})
    masks, _ = mesh_lib.shard_masks(mesh, ts.masks)
    with torch.no_grad():
        o, _ = mu.apply(ts.params, ts.model_state, local["image"], cfg=cfg,
                        masks=masks, mesh=mesh)
        x4 = [mu.encode(ts.params, ts.model_state, local["image"], cfg=cfg,
                        masks=masks, mesh=m)[0][3] for m in (mesh, None)]
    out["logits"] = mesh_lib.all_gather_rows(o.semantic, mesh).numpy()
    out["bottleneck_shape"] = tuple(x4[0].shape)
    out["bottleneck_diff"] = float((x4[0] - x4[1]).abs().max()
                                   / x4[1].abs().max())
    plans = mu.precompute_mask_plans(ts.masks)
    evals = {}
    for name, m in (("tp", mesh), ("one", None)):
        if m is None and rank != 0:
            break
        r = tstep.make_eval_step(cfg, task, device="cpu", mesh=m)(
            ts, dict(batch), plans)
        rec = dataclasses.replace(recipes.get("synthetic_panoptic"),
                                  img_size=16, batch_size=4,
                                  eval_max_queries=(10, 20))
        rcfg = loop.model_config(rec, rec.num_classes)
        rts = loop.setup_state(rec, rcfg, loop.make_optimizer(rec),
                               device="cpu")
        evals[name] = {
            "step": {k: float(v) for k, v in r["metrics"].items()},
            "pred": mesh_lib.all_gather_rows(r["pred"], m).numpy(),
            "evaluate": loop.evaluate(rec, None, rts, mesh=m, max_batches=1,
                                      device="cpu"),
            "panoptic": evaluators.evaluate_panoptic(
                rec, None, rts, max_batches=1, device="cpu", mesh=m)}
    out["evals"] = evals

    # the loop: one step, one writer
    rec = dataclasses.replace(recipes.get("synthetic_semantic"), img_size=16,
                              batch_size=4)
    res = loop.train(rec, None, workdir, max_steps=1, max_epochs=1,
                     mesh=mesh, data_fraction=0.25, device="cpu",
                     verbose=False)
    out["loop"] = {"epochs": len(res.history), "stop": res.stop_reason,
                   "sums": np.array([float(v.detach().sum())
                                     for v in res.state.params.values()])}
    return out
