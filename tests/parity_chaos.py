"""How far two f32 implementations of the same training step part in
lockstep: the evidence behind `chip_smoke.py`'s PARITY_CHAOTIC.

`maskunet_tpu_torch/tools/training_parity.py` trains the port's step and
the torch oracle (tests/torch_oracle.py) from the same weights on the same
batches and gates the per-step loss deviation. This script measures the
deviation's floor three ways (a script, not a test: pytest collects
`test_*.py` only):

    python tests/parity_chaos.py spread [--task embed] [--repeats 5]
        [--device cuda]
        # the tool's task N times on the same inputs: its statistics, each
        # step's port-vs-oracle deviation, and each side's run-to-run
        # spread (the card's nondeterministic reductions); torch only
    python tests/parity_chaos.py threads [--task embed] [--steps 8]
        # CPU: the tool's task at 1 and at 4 torch threads on the same
        # inputs: port vs port, oracle vs oracle (summation order only)
    JAX_PLATFORMS=cpu python tests/parity_chaos.py jax [--task embed]
        [--steps 10]
        # CPU: JAX's train step, the port's and the oracle's in lockstep on
        # JAX's triplets, each pair's deviation by step

Each prints JSON lines. The `jax` mode imports the JAX package; the other
two do not, so `spread` runs on the card's machine, which has no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from maskunet_tpu_torch.tools import training_parity as tp  # noqa: E402


def rel(a, b) -> list:
    a, b = np.asarray(a), np.asarray(b)
    return [float(x) for x in np.abs(a - b) / np.abs(b)]


def quiet_task(task: str, steps: int, device: str) -> dict:
    with contextlib.redirect_stdout(io.StringIO()):
        return tp.run_task(task, steps, 16, device=device)


def spread(args) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = [quiet_task(args.task, args.steps, args.device)
            for _ in range(args.repeats)]
    for i, r in enumerate(runs):
        print(json.dumps({"task": args.task, "device": args.device,
                          "rep": i, **{k: r[k] for k in tp.LIMITS},
                          "rel_by_step": rel(r["port_losses"],
                                             r["oracle_losses"])}),
              flush=True)
    for side in ("port_losses", "oracle_losses"):
        first = runs[0][side]
        worst = np.max([rel(r[side], first) for r in runs[1:]], axis=0)
        print(json.dumps({"side": side.split("_")[0],
                          "run_to_run_rel_by_step": worst.tolist()}),
              flush=True)


def threads(args) -> None:
    runs = {}
    for n in (1, 4):
        torch.set_num_threads(n)
        runs[n] = quiet_task(args.task, args.steps, "cpu")
    for side in ("port_losses", "oracle_losses"):
        print(json.dumps({"task": args.task, "side": side.split("_")[0],
                          "threads_1_vs_4_rel_by_step":
                          rel(runs[1][side], runs[4][side])}), flush=True)
    for n, r in runs.items():
        print(json.dumps({"task": args.task, "threads": n,
                          **{k: r[k] for k in tp.LIMITS},
                          "port_vs_oracle_rel_by_step":
                          rel(r["port_losses"], r["oracle_losses"])}),
              flush=True)


def jax_lockstep(args) -> None:
    """The tool's configuration (c_out 5, batch 4, 16 px, dropout 0, dense
    attention, AdamW 1e-3 / 1e-2, key 0 visible) for JAX's step, the
    port's and the oracle's, all three from the port's initial weights
    (`to_jax`), on JAX's triplets (derived as JAX's tool derives them)."""
    import jax
    import jax.numpy as jnp
    import optax

    from maskunet_tpu.core import state as jstate
    from maskunet_tpu.losses import triplet as jtri
    from maskunet_tpu.models import maskattn_unet as jmu
    from maskunet_tpu.train import step as jstep
    from maskunet_tpu_torch.core import state as tstate
    from maskunet_tpu_torch.models import maskattn_unet as tmu
    from maskunet_tpu_torch.train import loop as tloop
    from maskunet_tpu_torch.train import step as tstep
    from maskunet_tpu_torch.utils import jax_weights

    img, batch, c_out = 16, 4, 5
    embed = 16 if args.task == "embed" else 0
    ignore = 255 if args.task == "embed" else None
    tri_w = {"panoptic": 0.1, "embed": 0.5}.get(args.task, 0.0)
    ce_w = 0.9 if args.task == "panoptic" else 1.0
    kw = dict(c_out=c_out, img_size=img, dropout_rate=0.0, attn_impl="dense",
              embed_dim=embed, with_boundary_head=embed > 0)
    task_kw = dict(ce_weight=ce_w, triplet_weight=tri_w,
                   triplet_features="embeddings" if embed else "logits",
                   ignore_index=ignore, triplet_ignore_label=ignore)
    tcfg, jcfg = tmu.MaskAttnUNetConfig(**kw), jmu.MaskAttnUNetConfig(**kw)
    params, mstate = tmu.init(torch.Generator().manual_seed(0), tcfg)
    tree = jax_weights.to_jax(params, mstate, tcfg)
    masks = tuple(m.clone().index_fill_(1, torch.tensor([0]), True)
                  for m in tmu.make_attention_masks(
                      torch.Generator().manual_seed(1), batch, img))
    tx = optax.adamw(1e-3, weight_decay=1e-2)
    jts = jstate.create(jax.random.key(2),
                        *(jax.tree.map(jnp.asarray, t) for t in tree), tx,
                        masks=tuple(jnp.asarray(m.numpy()) for m in masks))
    jtrain = jax.jit(jstep.make_train_step(jcfg, jstep.TaskConfig(**task_kw),
                                           tx))
    tts = tstate.create(torch.Generator().manual_seed(2), params, mstate,
                        tloop.AdamW(1e-3, 1e-2), masks=masks)
    ttrain = tstep.make_train_step(tcfg, tstep.TaskConfig(**task_kw),
                                   mask_plans=tmu.precompute_mask_plans(
                                       masks), device="cpu")
    fixture = tp.load_fixture("torch_oracle")
    oracle = fixture.OracleUNet(3, c_out, img, embed_dim=embed,
                                boundary=embed > 0)
    fixture.load_params(oracle, tree[0])
    oracle.train(True)
    opt = torch.optim.AdamW(oracle.parameters(), lr=1e-3, weight_decay=1e-2)
    crit = torch.nn.CrossEntropyLoss(
        ignore_index=ignore if ignore is not None else -100)
    rng = np.random.default_rng(0)
    losses = {"jax": [], "port": [], "oracle": []}
    for _ in range(args.steps):
        x = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
        y = rng.integers(0, c_out, (batch, img, img))
        if ignore is not None:
            y[:, :2, :] = ignore
        batch_np = {"image": x, "label": y}
        tri = None
        if tri_w:
            inst = rng.integers(0, 4, (batch, img, img))
            batch_np["instance"] = inst
            _, _, trng = jax.random.split(
                jax.random.fold_in(jts.rng, jts.step), 3)
            tri = tuple(torch.from_numpy(np.array(t)) for t in
                        jtri.sample_triplets(trng, jnp.asarray(inst),
                                             num_samples=32,
                                             ignore_label=ignore))
        jts, jm = jtrain(jts, {k: jnp.asarray(v) for k, v in
                               batch_np.items()})
        tts, tm = ttrain(tts, batch_np, triplets=tri)
        opt.zero_grad()
        out = oracle(torch.from_numpy(x).permute(0, 3, 1, 2), list(masks))
        sem, emb = (out[0], out[2]) if embed else (out, None)
        loss = ce_w * crit(sem, torch.from_numpy(y))
        if tri is not None:
            loss = loss + tri_w * tp.torch_triplet(emb if embed else sem,
                                                   *tri)
        loss.backward()
        opt.step()
        losses["jax"].append(float(jm["loss"]))
        losses["port"].append(float(tm["loss"]))
        losses["oracle"].append(float(loss.detach()))
    print(json.dumps({"task": args.task, "losses": losses,
                      "port_vs_jax": rel(losses["port"], losses["jax"]),
                      "jax_vs_oracle": rel(losses["jax"], losses["oracle"]),
                      "port_vs_oracle": rel(losses["port"],
                                            losses["oracle"])}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("spread", "threads", "jax"))
    ap.add_argument("--task", default="embed", choices=tp.TASKS)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    args.steps = args.steps or {"spread": 20, "threads": 8,
                                "jax": 10}[args.mode]
    {"spread": spread, "threads": threads, "jax": jax_lockstep}[args.mode](
        args)


if __name__ == "__main__":
    main()
