"""Training-dynamics parity: the port against the torch oracle, in lockstep.

Counterpart of tools/training_parity.py. It trains the port's train step
and `tests/torch_oracle.py::OracleUNet` (an independent transcription of
the reference's equations) from the same weights on the same batches
(fixed attention masks, dropout off, AdamW with the reference's
hyperparameters), and compares the per-step losses. That checks the whole
training path: the gradients through every layer, BatchNorm's batch and
running statistics and AdamW's update, not the forward alone.

It covers the four loss patterns of the reference:
  semantic      CE
  summed        CE on summed-mask targets
  panoptic      0.9*CE + 0.1*triplet(logits)
  embed         CE(ignore 255) + 0.5*triplet(16-d embeddings)
The triplet term takes the same (anchor, positive, negative) pixel indices
on both sides: `losses.triplet.sample_triplets` draws them from a
generator of this tool's, and both the port's step (`triplets=`) and the
oracle's loss get them.

    python -m maskunet_tpu_torch.tools.training_parity [steps] [img_size]
        [task ...] [--literal] [--lr LR] [--wd WD] [--device cuda|cpu]

Defaults: 20 steps at 16 px, all four tasks, AdamW 1e-3 / 1e-2. Both
sides run on the device in exact f32 (no TF32). The gates are the JAX
tool's: the last-fifth mean losses within 2% (trajectory), the mean
per-step deviation within 1% (cumulative), the worst 20-step window's
within 3%; a failed gate exits with the failures.

--literal trains against the reference's literal classes
(`tests/literal_reference.py`, which execs them from the reference's
checkout), with `attn_output_layout='literal_view'` on the port's side;
it supports 'semantic' and 'embed'. The literal classes draw their masks
through `torch.randint`, which that module replaces with the fixed masks
on the CPU, so the literal side runs on the CPU. Without the checkout the
tool exits naming its path.

The oracle and the literal module are test fixtures: this tool loads them
by path from the checkout's `tests/`, never from a copy in the package.
A host without CUDA is refused unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os

TASKS = ("semantic", "summed", "panoptic", "embed")
LIMITS = {"traj": 0.02, "cum": 0.01, "win": 0.03}
_TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests")


def load_fixture(name: str):
    """`tests/<name>.py`, imported by path (tests/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_parity_{name}", os.path.join(_TESTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def torch_triplet(feats_nchw, a_idx, p_idx, n_idx, weight, margin=1.0):
    """The oracle's triplet term on NCHW features: the JAX tool's."""
    import torch

    bsz, c = feats_nchw.shape[0], feats_nchw.shape[1]
    feats = feats_nchw.permute(0, 2, 3, 1).reshape(bsz, -1, c)

    def gather(idx):
        ix = idx.to(feats.device).long()
        return torch.gather(feats, 1, ix.unsqueeze(-1).expand(-1, -1, c))

    a_f, p_f, n_f = gather(a_idx), gather(p_idx), gather(n_idx)
    d_ap = torch.sqrt(((a_f - p_f + 1e-6) ** 2).sum(-1))
    d_an = torch.sqrt(((a_f - n_f + 1e-6) ** 2).sum(-1))
    per = torch.relu(d_ap - d_an + margin)
    w = weight.to(feats.device)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def run_task(task_name: str, steps: int, img: int, literal: bool = False,
             lr: float = 1e-3, wd: float = 1e-2, *,
             device: str = "cuda") -> dict:
    """Trains both sides `steps` steps; returns the three gated statistics
    (`traj`, `cum`, `win`) and both loss histories."""
    import numpy as np
    import torch

    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.core.device import exact_f32, resolve_device
    from maskunet_tpu_torch.losses import triplet as triplet_lib
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib
    from maskunet_tpu_torch.utils import jax_weights

    dev = resolve_device(device)
    exact_f32()
    c_out, batch = 5, 4
    embed = 16 if task_name == "embed" else 0
    ignore = 255 if task_name == "embed" else None
    tri_w = {"panoptic": 0.1, "embed": 0.5}.get(task_name, 0.0)
    ce_w = 0.9 if task_name == "panoptic" else 1.0
    if literal and task_name not in ("semantic", "embed"):
        raise SystemExit(f"--literal supports semantic/embed, not {task_name}")

    cfg = mu.MaskAttnUNetConfig(
        c_out=c_out, img_size=img, dropout_rate=0.0, attn_impl="dense",
        embed_dim=embed, with_boundary_head=embed > 0,
        attn_output_layout="literal_view" if literal else "transpose")
    task = step_lib.TaskConfig(
        ce_weight=ce_w, triplet_weight=tri_w,
        triplet_features="embeddings" if embed else "logits",
        ignore_index=ignore, triplet_ignore_label=ignore)

    params, mstate = mu.init(torch.Generator().manual_seed(0), cfg)
    masks = mu.make_attention_masks(torch.Generator().manual_seed(1),
                                    batch, img)
    masks = tuple(m.clone().index_fill_(1, torch.tensor([0]), True)
                  for m in masks)                  # oracle NaN guard
    tree = jax_weights.to_jax(params, mstate, cfg)[0]

    if literal:
        lit = load_fixture("literal_reference")
        if not lit.available():
            raise SystemExit(f"--literal needs the reference's code at "
                             f"{lit.REF_CODE}, which is not there")
        oracle_dev = torch.device("cpu")
        oracle = lit.make_literal_unet("city" if embed else "ade", c_out,
                                       img, tree)
        # dead emb_layers exist only in the literal classes; freeze them
        # so AdamW's weight decay leaves params with no twin alone
        for name, p in oracle.named_parameters():
            if "emb_layer" in name:
                p.requires_grad_(False)
        mask_ctx = lit.inject_masks([m.numpy() for m in masks])
    else:
        oracle_dev = dev
        fixture = load_fixture("torch_oracle")
        oracle = fixture.OracleUNet(3, c_out, img, embed_dim=embed,
                                    boundary=embed > 0)
        fixture.load_params(oracle, tree)
        mask_ctx = contextlib.nullcontext()
    oracle.to(oracle_dev).train(True)
    opt = torch.optim.AdamW(
        [p for p in oracle.parameters() if p.requires_grad],
        lr=lr, weight_decay=wd)
    criterion = torch.nn.CrossEntropyLoss(
        ignore_index=ignore if ignore is not None else -100)
    t_masks = [m.to(oracle_dev) for m in masks]

    dev_masks = tuple(m.to(dev) for m in masks)
    ts = state_lib.create(torch.Generator(device=dev).manual_seed(2),
                          {k: v.to(dev) for k, v in params.items()},
                          {k: v.to(dev) for k, v in mstate.items()},
                          loop_lib.AdamW(lr, wd), masks=dev_masks)
    train_step = step_lib.make_train_step(
        cfg, task, mask_plans=mu.precompute_mask_plans(dev_masks),
        device=dev)
    triplet_gen = torch.Generator(device=dev).manual_seed(3)

    rng = np.random.default_rng(0)
    max_rel = 0.0
    rels: list[float] = []
    port_hist: list[float] = []
    torch_hist: list[float] = []
    with mask_ctx:   # literal: its first forward consumes the queue
        for i in range(steps):
            x = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
            if task_name == "summed":
                # summed-mask map: overlap counts as class indices
                n_inst = 3
                msks = rng.random((n_inst, batch, img, img)) < 0.25
                y = np.clip(msks.sum(0), 0, c_out - 1).astype(np.int64)
            else:
                y = rng.integers(0, c_out, (batch, img, img))
            if ignore is not None:
                y = y.copy()
                y[:, :2, :] = ignore
            batch_data = {"image": x, "label": y}
            triplets = None
            if tri_w > 0.0:
                inst = rng.integers(0, 4, (batch, img, img))
                batch_data["instance"] = inst
                triplets = triplet_lib.sample_triplets(
                    triplet_gen, torch.from_numpy(inst).to(dev),
                    num_samples=task.triplet_samples, ignore_label=ignore)

            ts, metrics = train_step(ts, batch_data, triplets=triplets)
            port_loss = float(metrics["loss"])

            opt.zero_grad()
            xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(oracle_dev)
            out = oracle(xt) if literal else oracle(xt, t_masks)
            sem, emb_t = (out[0], out[2]) if embed else (out, None)
            loss = ce_w * criterion(sem, torch.from_numpy(y).to(oracle_dev))
            if triplets is not None:
                feats = emb_t if embed else sem
                loss = loss + tri_w * torch_triplet(feats, *triplets)
            loss.backward()
            opt.step()
            torch_loss = float(loss.detach())

            rel = abs(port_loss - torch_loss) / max(abs(torch_loss), 1e-8)
            max_rel = max(max_rel, rel)
            rels.append(rel)
            port_hist.append(port_loss)
            torch_hist.append(torch_loss)
            if i % 10 == 0 or rel > 0.01:
                print(f"  step {i:3d}: port {port_loss:.6f} "
                      f"torch {torch_loss:.6f} rel {rel:.2e}", flush=True)

    # The JAX tool's three gated statistics: per-step losses of long
    # lockstep runs drift apart chaotically (f32 summation order, AdamW's
    # normalisation, the triplet's relu kinks), so parity is judged on
    # the trajectory:
    #   traj: relative difference of the last-fifth mean losses
    #   cum:  mean per-step deviation over all steps
    #   win:  worst sliding 20-step mean deviation
    tail = max(1, steps // 5)
    pm = float(np.mean(port_hist[-tail:]))
    tm = float(np.mean(torch_hist[-tail:]))
    traj_rel = abs(pm - tm) / max(abs(tm), 1e-8)
    cum_rel = float(np.mean(rels))
    w = max(1, min(20, steps))
    win_rel = max(float(np.mean(rels[i:i + w]))
                  for i in range(0, max(steps - w, 0) + 1))
    print(f"[{task_name}] max per-step deviation {max_rel:.2e}; "
          f"last-{tail}-step mean port {pm:.4f} vs torch {tm:.4f} "
          f"(rel {traj_rel:.2e}); cumulative mean dev {cum_rel:.2e}; "
          f"worst {w}-step window mean dev {win_rel:.2e}")
    return {"traj": traj_rel, "cum": cum_rel, "win": win_rel,
            "port_losses": port_hist, "oracle_losses": torch_hist}


def run(steps: int = 20, img_size: int = 16, tasks=TASKS, *,
        literal: bool = False, lr: float = 1e-3, wd: float = 1e-2,
        device: str = "cuda") -> dict:
    """`run_task` for each task; prints the JAX tool's summary line.
    Returns {task: run_task's result}."""
    worst = {t: run_task(t, steps, img_size, literal=literal, lr=lr, wd=wd,
                         device=device) for t in tasks}
    print(f"\nsummary vs {'LITERAL reference' if literal else 'oracle'}:",
          {k: {s: f"{v[s]:.2e}" for s in LIMITS} for k, v in worst.items()})
    return worst


def gate_failures(worst: dict) -> list:
    """(task, statistic, value) of every statistic above its gate."""
    return [(t, s, v[s]) for t, v in worst.items()
            for s, lim in LIMITS.items() if v[s] > lim]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="training_parity")
    ap.add_argument("steps", type=int, nargs="?", default=20)
    ap.add_argument("img_size", type=int, nargs="?", default=16)
    ap.add_argument("tasks", nargs="*")
    ap.add_argument("--literal", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--wd", type=float, default=1e-2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("training_parity", args.device)
    tasks = args.tasks or (["semantic", "embed"] if args.literal
                           else list(TASKS))
    worst = run(args.steps, args.img_size, tasks, literal=args.literal,
                lr=args.lr, wd=args.wd, device=args.device)
    failed = gate_failures(worst)
    if failed:
        raise SystemExit(f"training dynamics diverged: {failed} "
                         f"(limits {LIMITS})")
    print("training-dynamics parity OK (traj<2%, cum<1%, window<3%)")
    return worst


if __name__ == "__main__":
    main()
