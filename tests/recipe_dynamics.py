"""Train one recipe of either package on a fake layout and print its
validation metrics: a probe of training dynamics over many steps, which
the unit tests (one step each) do not reach.

    python tests/recipe_dynamics.py --package port --recipe coco_panoptic \\
        --seeds 42 7 --img-size 32 --dtype float32 --device cpu
    JAX_PLATFORMS=cpu python tests/recipe_dynamics.py --package jax ...

Each run: `make_fake_dataset`'s layout at its defaults (96 px scenes, 6
classes for ADE and COCO) with `--n` training images, the recipe with its
batch capped at 8, lr 1e-3, `--img-size` and the seed replaced, `--epochs`
epochs without checkpoints, then the semantic evaluation and, for a
panoptic recipe, `evaluate_panoptic` over 2 batches: the settings of
`tools/run_all_recipes.py`. One JSON line per seed. The port runs on
`--device` (the card by default); `--package jax` imports the JAX package
and runs where JAX runs, so only the port's side runs on the card.
`--attn-impl` is the model's ('auto': the port's flash path everywhere,
JAX's flash on a TPU and dense elsewhere); MASKUNET_SAFE_SOFTMAX=1 in the
environment gives the flash path an online max in both packages.

For the port, `folded_agreement` is the share of validation pixels whose
argmax is the same under the eval forward (what `predict_directory`
runs) and under the BN-folded inference forward (what `serve` runs) of
the trained state, at `--dtype`; `folded_logit_cos` the cosine of their
semantic logits over the same rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def folded_agreement(rec, root: str, ts, *, dtype: str, attn_impl: str,
                     device: str) -> dict:
    """The port's eval forward against its BN-folded forward on the
    validation set: argmax agreement over the valid rows' pixels, and the
    cosine of the semantic logits."""
    import torch

    from maskunet_tpu_torch.data import pipeline
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.tasks.datasets import make_datasets
    from maskunet_tpu_torch.train import loop

    _, val_ds, classes = make_datasets(rec, root)
    cfg = loop.model_config(rec, classes, attn_impl=attn_impl,
                            compute_dtype=dtype)
    plans = mu.precompute_mask_plans(ts.masks)
    same = total = 0
    dot = norm_o = norm_f = 0.0
    with torch.no_grad():
        folded = mu.cast_params_for_inference(
            mu.fold_bn_for_inference(ts.params, ts.model_state, cfg))
        batches = pipeline.BatchIterator(val_ds, rec.batch_size,
                                         shuffle=False, drop_last=False,
                                         pad_last=True)
        for batch in batches.epoch(0):
            x = pipeline.to_device(batch, device)["image"]
            o, _ = mu.apply(ts.params, ts.model_state, x, cfg=cfg,
                            masks=ts.masks, train=False, mask_plans=plans)
            f, _ = mu.apply(folded, None, x, cfg=cfg, masks=ts.masks,
                            folded=True, mask_plans=plans)
            valid = torch.as_tensor(batch["valid"], device=o.semantic.device)
            lo, lf = o.semantic[valid].float(), f.semantic[valid].float()
            same += int((lo.argmax(-1) == lf.argmax(-1)).sum())
            total += lo[..., 0].numel()
            dot += float((lo * lf).sum())
            norm_o += float((lo * lo).sum())
            norm_f += float((lf * lf).sum())
    return {"folded_agreement": same / total,
            "folded_logit_cos": dot / (norm_o * norm_f) ** 0.5}


def run(package: str, name: str, seed: int, *, img_size: int, dtype: str,
        epochs: int, n: int, device: str,
        attn_impl: str = "auto") -> dict:
    from maskunet_tpu_torch.tools import run_all_recipes

    if package == "jax":
        from maskunet_tpu.tasks import evaluators, recipes
        from maskunet_tpu.train import loop
        kw = {}
    else:
        from maskunet_tpu_torch.tasks import evaluators, recipes
        from maskunet_tpu_torch.train import loop
        kw = {"device": device}
    rec = recipes.get(name)
    kind = {"ade20k": "ade", "coco": "coco",
            "cityscapes": "cityscapes"}[rec.dataset]
    root = run_all_recipes.ensure_data(kind, n)
    rec = dataclasses.replace(rec, batch_size=min(rec.batch_size, 8),
                              lr=1e-3, img_size=img_size, seed=seed)
    workdir = tempfile.mkdtemp(prefix=f"dynamics_{name}_")
    t0 = time.time()
    try:
        res = loop.train(rec, root, workdir, max_epochs=epochs, log_every=0,
                         verbose=False, save_checkpoints=False,
                         compute_dtype=dtype, attn_impl=attn_impl, **kw)
        out = {"package": package, "recipe": name, "seed": seed,
               "img_size": img_size, "dtype": dtype, "attn_impl": attn_impl,
               "safe_softmax": os.environ.get("MASKUNET_SAFE_SOFTMAX", "0"),
               "device": (device if package == "port" else "jax default"),
               "epochs_run": len(res.history), "stop": res.stop_reason,
               "train_loss": res.history[-1]["loss"],
               "losses": [round(h["loss"], 4) for h in res.history],
               "val_miou": loop.evaluate(rec, root, res.state,
                                         compute_dtype=dtype,
                                         attn_impl=attn_impl, **kw)["miou"]}
        if package == "port":
            out.update(folded_agreement(rec, root, res.state, dtype=dtype,
                                        attn_impl=attn_impl, device=device))
        if rec.task == "panoptic":
            pan = evaluators.evaluate_panoptic(rec, root, res.state,
                                               max_batches=2,
                                               attn_impl=attn_impl, **kw)
            out.update(pq=pan["pq"]["All"]["pq"], ap=pan["ap"]["AP"],
                       pq_things=pan["pq"].get("Things", {"pq": -1.0})["pq"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["seconds"] = time.time() - t0
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--recipe", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="auto",
                    choices=("auto", "dense", "flash"))
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(run(args.package, args.recipe, seed,
                             img_size=args.img_size, dtype=args.dtype,
                             epochs=args.epochs, n=args.n,
                             device=args.device,
                             attn_impl=args.attn_impl)),
              flush=True)


if __name__ == "__main__":
    main()
