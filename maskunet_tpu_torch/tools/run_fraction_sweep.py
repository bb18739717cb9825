"""Data-efficiency sweep on the card: train coco_panoptic on 10/25/50/75/
100% of its data.

Counterpart of tools/run_fraction_sweep.py, with its flags and output
keys: for each fraction of the training split (`train(data_fraction=)`),
and for each of `--seeds` seeds, train until the loop stops and evaluate
mIoU / PQ / AP (`evaluate_panoptic`); one JSON line a fraction (the
seeds' means) is appended to <workdir>/sweep_results.jsonl. This
reproduces the reference's headline experiment
(figures/Segmentation_performance.png). The data are read from
`--data-root` in the reference's layout; nothing is downloaded, so
without a real COCO it runs on fake layouts
(`maskunet_tpu_torch.tools.make_fake_dataset coco <dir>`).

    python -m maskunet_tpu_torch.tools.run_fraction_sweep \\
        --data-root /data/COCO --workdir runs/sweep \\
        [--fractions 0.1 0.25 0.5 0.75 1.0] [--max-epochs N] \\
        [--recipe coco_panoptic] [--device cuda|cpu]

`maskunet_tpu_torch.tools.plot_sweep` draws the file. A host without
CUDA is refused unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="run_fraction_sweep")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--workdir", default="runs/sweep")
    ap.add_argument("--recipe", default="coco_panoptic")
    ap.add_argument("--fractions", type=float, nargs="+",
                    default=[0.1, 0.25, 0.5, 0.75, 1.0])
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--max-eval-batches", type=int, default=None)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--lr", type=float, default=None,
                    help="demo-lr override for fake-data sweeps (the "
                         "reference coco lr of 1e-5 needs real-data "
                         "step counts); recorded in each output row")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=1,
                    help="average metrics over N training seeds per "
                         "fraction (single-seed runs are noisy near the "
                         "plateau; the reference's trend chart is about "
                         "the mean effect of data quantity)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> list[dict]:
    args = parse(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("run_fraction_sweep", args.device)
    from maskunet_tpu_torch.tasks import evaluators, recipes as recipes_lib
    from maskunet_tpu_torch.train import loop

    recipe = recipes_lib.get(args.recipe)
    if args.lr is not None:
        recipe = dataclasses.replace(recipe, lr=args.lr)
    if args.batch_size is not None:
        recipe = dataclasses.replace(recipe, batch_size=args.batch_size)
    os.makedirs(args.workdir, exist_ok=True)
    results_path = os.path.join(args.workdir, "sweep_results.jsonl")
    records = []
    with open(results_path, "a") as out:
        for frac in args.fractions:
            per_seed = []
            for s in range(args.seeds):
                rec_s = dataclasses.replace(recipe, seed=recipe.seed + s)
                workdir = os.path.join(
                    args.workdir, f"frac_{int(frac * 100)}_s{s}")
                print(f"=== fraction {frac} seed {rec_s.seed} "
                      f"-> {workdir} ===")
                # save_checkpoints=False: eval runs on the returned
                # in-memory state; per-epoch full-state saves would
                # dominate epoch time at these dataset sizes
                res = loop.train(rec_s, args.data_root, workdir,
                                 max_epochs=args.max_epochs,
                                 data_fraction=frac,
                                 compute_dtype=args.compute_dtype,
                                 save_checkpoints=False,
                                 log_every=0, verbose=True,
                                 device=args.device)
                pan = evaluators.evaluate_panoptic(
                    rec_s, args.data_root, res.state,
                    max_batches=args.max_eval_batches, device=args.device)
                per_seed.append({
                    "train_loss": res.best_loss,
                    "train_miou": res.best_iou,
                    "epochs_run": float(len(res.history)),
                    "stop_reason": res.stop_reason,
                    "loop_img_per_sec_compile_dominated":
                        res.images_per_sec,
                    "val_miou": pan["miou"],
                    "pq": pan["pq"]["All"]["pq"],
                    "ap": pan["ap"]["AP"],
                })
            record = {"fraction": frac}
            for k in per_seed[0]:
                if k == "stop_reason":
                    record["stop_reasons"] = [r[k] for r in per_seed]
                    continue
                record[k] = sum(r[k] for r in per_seed) / len(per_seed)
            record["seeds"] = args.seeds
            if args.seeds > 1:
                record["per_seed_pq"] = [r["pq"] for r in per_seed]
            # always recorded: lr_override null == reference
            # hyperparameters (coco_panoptic lr 1e-5 / wd 1e-4), the
            # headline-experiment configuration
            record["lr_override"] = args.lr
            record["max_epochs_budget"] = args.max_epochs
            out.write(json.dumps(record) + "\n")
            out.flush()
            print(json.dumps(record))
            records.append(record)
    print(f"sweep complete -> {results_path}")
    return records


if __name__ == "__main__":
    main()
