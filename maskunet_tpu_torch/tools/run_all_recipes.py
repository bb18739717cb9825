"""Run every (dataset x task) recipe end-to-end on fake on-disk data.

Counterpart of tools/run_all_recipes.py, on `--device` (the card unless
the caller asks for the CPU): train then evaluate each of the nine
reference recipes on layouts that the port's `make_fake_dataset` writes
(the reference's disk layouts), recording the loop's img/s and the
metrics. The same arguments, output keys and `--require-nonzero` rule as
the JAX tool. The summary JSON goes to `--out` when given.

    python -m maskunet_tpu_torch.tools.run_all_recipes --epochs 30 --n 48 \\
        --lr 1e-3 --require-nonzero --out <file>

The fake layouts go under the system's temporary directory, one per kind
and size, written once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile

NAMES = ("ade_semantic", "ade_instance", "ade_panoptic",
         "city_semantic", "city_instance", "city_panoptic",
         "coco_semantic", "coco_instance", "coco_panoptic")


def ensure_data(kind: str, n: int = 24) -> str:
    """The fake layout of `kind` ('ade', 'coco', 'cityscapes') with `n`
    training images, written at the JAX tool's defaults (96 px scenes,
    6 classes for ADE and COCO) if it is not there yet."""
    from maskunet_tpu_torch.tools import make_fake_dataset as fake

    root = os.path.join(tempfile.gettempdir(), f"fake_{kind}_e2e_{n}")
    if not os.path.isdir(root):
        tmp = root + f".{os.getpid()}.tmp"
        {"coco": fake.make_coco, "ade": fake.make_ade,
         "cityscapes": fake.make_cityscapes}[kind](tmp, n=n)
        os.replace(tmp, root)
    return root


def run_recipe(name: str, epochs: int, *, n_data: int = 24,
               lr: float | None = None, eval_batches: int = 2,
               step_budget: int | None = None,
               device: str = "cuda") -> dict:
    from maskunet_tpu_torch.tasks import evaluators, recipes as recipes_lib
    from maskunet_tpu_torch.train import loop

    rec = recipes_lib.get(name)
    kind = {"ade20k": "ade", "coco": "coco",
            "cityscapes": "cityscapes"}[rec.dataset]
    data_root = ensure_data(kind, n_data)
    # fake scenes are 96px; keep the reference 128 target size (resize
    # path exercised) but shrink batch for the 1-per-batch recipes
    rec = dataclasses.replace(rec, batch_size=min(rec.batch_size, 8))
    if step_budget is not None:
        # plateau mode: train until the reference EarlyStopping (patience
        # 10, ade_semantic.py:382) fires, under a uniform optimizer-step
        # budget so the batch-1 recipes don't get 8x the epochs
        steps_per_epoch = max(1, n_data // rec.batch_size)
        epochs = max(12, step_budget // steps_per_epoch)
    if lr is not None:
        # a uniform demo lr makes the short fake-data runs metric-bearing
        # (nonzero PQ/AP through the full eval stack); recorded per row
        rec = dataclasses.replace(rec, lr=lr)
    workdir = tempfile.mkdtemp(prefix=f"e2e_{name}_")
    try:
        res = loop.train(rec, data_root, workdir, max_epochs=epochs,
                         log_every=0, verbose=step_budget is not None,
                         save_checkpoints=False,
                         keep_best_state=step_budget is not None,
                         compute_dtype="bfloat16", device=device)
        traj = [round(h["loss"], 4) for h in res.history]
        out = {
            "recipe": name,
            "lr": rec.lr, "weight_decay": rec.weight_decay,
            "epochs_run": len(res.history),
            "epochs_budget": epochs,
            "stopped_before_budget": len(res.history) < epochs,
            "stop_reason": res.stop_reason,
            "best_train_miou": round(res.best_iou, 4),
            "loss_trajectory": traj,
            "loss_decreased": traj[-1] < traj[0],
            "train_loss": round(res.history[-1]["loss"], 4),
            "train_miou": round(res.history[-1]["miou"], 4),
            # the whole run's loop rate, first steps included
            "loop_img_per_sec_compile_dominated": round(
                res.images_per_sec, 1),
        }
        if lr is not None:
            out["lr_override"] = lr

        def _eval_state(ts, suffix: str, export_dir: str | None) -> None:
            sem = loop.evaluate(rec, data_root, ts, compute_dtype="bfloat16",
                                device=device)
            out["val_miou" + suffix] = round(sem["miou"], 4)
            out["val_loss" + suffix] = round(sem["loss"], 4)
            if rec.task == "panoptic":
                pan = evaluators.evaluate_panoptic(
                    rec, data_root, ts, max_batches=eval_batches,
                    export_dir=export_dir, device=device)
                out["pq" + suffix] = round(pan["pq"]["All"]["pq"], 4)
                out["pq_things" + suffix] = round(pan["pq"].get(
                    "Things", {"pq": -1.0})["pq"], 4)
                out["ap" + suffix] = round(pan["ap"]["AP"], 4)
                if export_dir is not None:
                    out["exported"] = os.path.exists(
                        os.path.join(export_dir, "predictions.json"))
            elif rec.task == "instance":
                q = rec.eval_max_queries[-1]
                inst = evaluators.evaluate_instances(
                    rec, data_root, ts, max_queries=(q,),
                    max_batches=eval_batches, device=device)
                out["ap" + suffix] = round(inst[q]["AP"], 4)

        _eval_state(res.state, "", os.path.join(workdir, "export"))
        if res.best_state is not None:
            _eval_state(res.best_state, "_best", None)
        if name == "coco_instance":
            out["ap_note"] = ("class-agnostic AP over summed-target "
                              "maps; degenerate by reference design "
                              "(PARITY.md §2.4)")
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="summary path (default: none written)")
    ap.add_argument("--n", type=int, default=24,
                    help="fake train images per dataset")
    ap.add_argument("--lr", type=float, default=None,
                    help="uniform demo-lr override (recorded per row)")
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--require-nonzero", action="store_true",
                    help="fail if any panoptic/instance recipe reports "
                         "PQ or AP of 0")
    ap.add_argument("--only", nargs="+", default=None,
                    help="run only these recipes")
    ap.add_argument("--plateau", action="store_true",
                    help="ignore --epochs; train each recipe at its "
                         "reference lr until EarlyStopping(patience=10) "
                         "fires, bounded by --step-budget optimizer steps")
    ap.add_argument("--step-budget", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.plateau and args.only is None:
        args.only = ["ade_semantic", "ade_panoptic", "city_semantic",
                     "city_instance", "coco_semantic", "coco_instance",
                     "coco_panoptic"]

    names = list(NAMES)
    if args.only:
        unknown = set(args.only) - set(names)
        if unknown:
            raise SystemExit(f"unknown recipes: {sorted(unknown)}")
        names = [n for n in names if n in args.only]
    rows = []
    for name in names:
        print(f"=== {name}", flush=True)
        try:
            row = run_recipe(name, args.epochs, n_data=args.n, lr=args.lr,
                             eval_batches=args.eval_batches,
                             step_budget=(args.step_budget if args.plateau
                                          else None),
                             device=args.device)
        except Exception as e:  # noqa: BLE001 - one row per recipe
            row = {"recipe": name, "error": repr(e)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out is not None:
        summary = {"epochs": args.epochs, "n_train_images": args.n,
                   "lr_override": args.lr, "plateau": args.plateau,
                   "step_budget": (args.step_budget if args.plateau
                                   else None),
                   "device": args.device, "rows": rows}
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    failed = [r["recipe"] for r in rows if "error" in r]
    zeroed = [r["recipe"] for r in rows
              if ("pq" in r and r["pq"] <= 0.0)
              or ("ap" in r and r["ap"] <= 0.0)]
    print(f"\n{len(rows) - len(failed)}/{len(rows)} recipes OK; "
          f"failures: {failed}; zero-metric rows: {zeroed}")
    if failed or (args.require_nonzero and zeroed):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
