"""Command-line entry points of the port.

Counterpart of maskunet_tpu/cli.py, with its subcommands, flags and JSON
result lines, on the card (`--platform cpu` for the CPU):

    python -m maskunet_tpu_torch.cli recipes
    python -m maskunet_tpu_torch.cli train --recipe ade_semantic \\
        --data-root /data/ADEK --workdir runs/ade [--max-steps N]
    python -m maskunet_tpu_torch.cli evaluate --recipe ade_semantic \\
        --data-root /data/ADEK --workdir runs/ade [--tag best]
    python -m maskunet_tpu_torch.cli visualize --recipe ... --workdir runs/ade
    python -m maskunet_tpu_torch.cli predict --recipe ... --images dir/ \\
        --out masks/
    python -m maskunet_tpu_torch.cli export --recipe ... --out artifact/ \\
        [--quantize int8 [--calibrate-images dir/]]
    python -m maskunet_tpu_torch.cli import-torch --recipe ... \\
        --torch-checkpoint checkpoint_ade.pth   # reference .pth -> ours
    python -m maskunet_tpu_torch.serve --recipe ... --port 8799   # HTTP

What differs from the JAX CLI:
- `--n-data`, `--pipeline M` (M > 1), `--distributed` and its
  `--coordinator`, `--num-processes`, `--process-id` belong to the
  parallel slice of the port, which is not ported yet: each prints one
  error line and returns 2.
- `--platform` is the torch device, `cuda` (default) or `cpu`;
  `--compute-dtype auto` is bf16 on the card and f32 on the CPU.
- `train --resume` counts `--max-epochs` and `--max-steps` from the
  checkpoint's step (JAX restarts both at 0).
- `export` writes a `torch.export` artifact, tied to the device it was
  traced on, which needs this package's flash operators to load
  (`maskunet_tpu_torch.export`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_PARALLEL = ("belongs to the parallel slice of the port (data, pipeline "
             "and multi-host parallelism), which is not ported yet")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--recipe", required=True)
    p.add_argument("--data-root", default=None)
    p.add_argument("--workdir", default="runs")
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "dense", "flash"])
    p.add_argument("--attn-output-layout", default="auto",
                   choices=["auto", "transpose", "literal_view"],
                   help="attention-output un-flatten semantics. auto: "
                        "'literal_view' when the workdir checkpoint was "
                        "imported from a reference .pth (those weights "
                        "encode the reference's raw .view(B,C,H,W) "
                        "scramble, ade_semantic.py:190 — recorded by "
                        "import-torch in a sidecar), else 'transpose'")
    p.add_argument("--compute-dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="auto: bfloat16 on the card, float32 on the CPU")
    p.add_argument("--n-data", type=int, default=None,
                   help=f"data-parallel mesh size: {_PARALLEL}")
    p.add_argument("--platform", default=None, choices=["cuda", "cpu"],
                   help="the torch device (default: cuda, the card; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--distributed", action="store_true",
                   help=f"multi-host: {_PARALLEL}")
    p.add_argument("--coordinator", default=None,
                   help="with --distributed (refused)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --distributed (refused)")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --distributed (refused)")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="maskunet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("recipes", help="list available recipes")

    tp = sub.add_parser("train")
    _add_common(tp)
    tp.add_argument("--max-steps", type=int, default=None)
    tp.add_argument("--max-epochs", type=int, default=None)
    tp.add_argument("--resume", action="store_true",
                    help="continue from the workdir's 'latest' checkpoint; "
                         "--max-epochs and --max-steps then count from its "
                         "step, so the run ends where an uninterrupted one "
                         "would (the JAX CLI restarts both counts at 0)")
    tp.add_argument("--log-every", type=int, default=500)
    tp.add_argument("--data-fraction", type=float, default=1.0,
                    help="seeded random train-set fraction (sweep support)")
    tp.add_argument("--debug-nan", action="store_true",
                    help="raise on non-finite step metrics")
    tp.add_argument("--step-timeout", type=float, default=None,
                    metavar="SEC",
                    help="warn if no training step completes for SEC "
                         "seconds (hung device detection; size it above "
                         "the first step's kernel build)")
    tp.add_argument("--step-timeout-abort", action="store_true",
                    help="with --step-timeout: exit 42 on a stall "
                         "instead of warning, so a supervisor can "
                         "restart the run with --resume")
    tp.add_argument("--no-cache", action="store_true",
                    help="disable the in-RAM decoded-example cache")
    tp.add_argument("--remat-attention", action="store_true",
                    help="recompute the attention blocks in the backward "
                         "instead of storing activations (memory headroom "
                         "for larger batches / resolutions; numerics are "
                         "unchanged)")
    tp.add_argument("--grad-accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step "
                         "(effective batch = batch_size * grad_accum)")
    tp.add_argument("--img-size", type=int, default=None,
                    help="override the recipe's training resolution "
                         "(e.g. 16/32 for CPU smoke runs; checkpoints "
                         "record the size they were trained at)")
    tp.add_argument("--pipeline", type=int, default=1, metavar="M",
                    help=f"pipeline parallelism with M >= 2: {_PARALLEL}")
    tp.add_argument("--lr-schedule", default=None,
                    choices=["cosine", "warmup_cosine", "step"],
                    help="optional lr schedule (default: the reference's "
                         "constant lr)")
    tp.add_argument("--warmup-steps", type=int, default=0)
    tp.add_argument("--eval-every", type=int, default=None,
                    help="run validation every N epochs (logged as val_*)")
    tp.add_argument("--eval-max-batches", type=int, default=8,
                    help="batches per in-training validation pass "
                         "(val_* metrics are estimates over this sample; "
                         "val_sample_images is logged alongside)")
    tp.add_argument("--init-from", default=None,
                    help="warm-start params from another run's checkpoint")
    tp.add_argument("--init-drop", nargs="*", default=[],
                    help="param path prefixes to keep fresh (e.g. "
                         "final_conv final_bn for a head swap)")
    tp.add_argument("--profile-dir", default=None,
                    help="capture a device trace of a few steady-state "
                         "steps to this directory (torch.profiler)")
    tp.add_argument("--profile-steps", type=int, default=5,
                    help="steps in the trace window (default 5)")

    ep = sub.add_parser("evaluate")
    _add_common(ep)
    ep.add_argument("--tag", default="best", choices=["best", "latest"])
    ep.add_argument("--max-batches", type=int, default=None)
    ep.add_argument("--mode", default="semantic",
                    choices=["semantic", "instances", "panoptic"],
                    help="semantic: loss+mIoU; instances: AP with "
                         "max_queries sweep; panoptic: AP+PQ+mIoU")
    ep.add_argument("--max-queries", type=int, nargs="+", default=None,
                    help="default: the recipe's reference sweep")
    ep.add_argument("--split", default="val", choices=["val", "train"],
                    help="instances mode: evaluate on the train split "
                         "(the reference's city_instance quirk)")
    ep.add_argument("--export-dir", default=None,
                    help="panoptic mode: write id2rgb prediction PNGs + "
                         "predictions.json here")

    vp = sub.add_parser("visualize", help="save sample + prediction panels "
                                          "(needs matplotlib)")
    _add_common(vp)
    vp.add_argument("--tag", default="best", choices=["best", "latest"])
    vp.add_argument("--index", type=int, default=0)
    vp.add_argument("--out", default="viz")

    pp = sub.add_parser("predict",
                        help="batch inference over a directory of images")
    _add_common(pp)
    pp.add_argument("--tag", default="best", choices=["best", "latest"])
    pp.add_argument("--images", required=True)
    pp.add_argument("--out", default="predictions")
    pp.add_argument("--num-classes", type=int, default=None,
                    help="override when no dataset root is given")
    pp.add_argument("--panels", action="store_true")
    pp.add_argument("--instances", action="store_true",
                    help="also decode and write instance-id maps "
                         "(DBSCAN over embeddings for 3-head models, "
                         "per-class connected components otherwise)")
    pp.add_argument("--panoptic", action="store_true",
                    help="also write panopticapi-layout panoptic "
                         "predictions (id2rgb PNGs + segments json)")

    ip = sub.add_parser(
        "import-torch",
        help="convert a reference PyTorch .pth state_dict into a "
             "checkpoint this package's evaluate/predict/serve/train "
             "--init-from can load")
    _add_common(ip)
    ip.add_argument("--torch-checkpoint", required=True,
                    help="reference checkpoint (e.g. checkpoint_ade.pth)")
    ip.add_argument("--num-classes", type=int, default=None,
                    help="override when no dataset root is given")

    xp = sub.add_parser(
        "export",
        help="freeze a checkpoint into a self-contained torch.export "
             "serving artifact (see maskunet_tpu_torch.export: it runs on "
             "the device it was exported on and needs this package's "
             "flash operators to load)")
    _add_common(xp)
    xp.add_argument("--tag", default="best", choices=["best", "latest"])
    xp.add_argument("--out", required=True, help="artifact directory")
    xp.add_argument("--num-classes", type=int, default=None,
                    help="override when no dataset root is given")
    xp.add_argument("--batch-size", type=int, default=None)
    xp.add_argument("--platforms", default=None,
                    help="the one device to export for, which must be "
                         "--platform's (a torch artifact runs only on the "
                         "device it was traced on: a list is refused)")
    xp.add_argument("--quantize", default=None, choices=["int8"],
                    help="bake int8 conv weights (half the bytes of bf16 "
                         "convs; not bit-equal to the float model)")
    xp.add_argument("--calibrate-images", default=None,
                    help="with --quantize int8: sample-image dir for "
                         "static activation scales")
    return parser


def _error(message: str) -> int:
    print(f"error: {message}", file=sys.stderr)
    return 2


def _refused_parallel(args) -> str | None:
    """The first parallel flag set, named, or None."""
    if args.n_data is not None:
        return "--n-data"
    if getattr(args, "pipeline", 1) > 1:
        return "--pipeline"
    if args.distributed:
        return "--distributed"
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            return "--" + flag.replace("_", "-")
    return None


def _num_classes(args, recipe) -> int:
    if getattr(args, "num_classes", None) is not None:
        return args.num_classes
    from maskunet_tpu_torch.tasks.datasets import make_datasets
    return make_datasets(recipe, args.data_root)[2]


def _state(args, recipe, num_classes: int, device: str):
    """(model config, a fresh state) for `recipe` on `device`."""
    from maskunet_tpu_torch.train import loop
    cfg = loop.model_config(recipe, num_classes, attn_impl=args.attn_impl,
                            compute_dtype=args.compute_dtype)
    ts = loop.setup_state(recipe, cfg, loop.make_optimizer(recipe),
                          device=device)
    return cfg, ts


def _checkpoint(args, recipe) -> str:
    return os.path.join(args.workdir,
                        f"{recipe.checkpoint_name}_{args.tag}.msgpack")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.cmd == "recipes":
        from maskunet_tpu_torch.tasks.recipes import RECIPES
        for name, r in sorted(RECIPES.items()):
            print(f"{name:22s} {r.dataset:10s} {r.task:9s} "
                  f"batch={r.batch_size:<3d} lr={r.lr:g} wd={r.weight_decay:g}")
        return 0

    flag = _refused_parallel(args)
    if flag is not None:
        return _error(f"{flag} {_PARALLEL}")

    import dataclasses

    from maskunet_tpu_torch.core import checkpoint as ckpt_lib
    from maskunet_tpu_torch.tasks import recipes as recipes_lib
    try:
        recipe = recipes_lib.get(args.recipe)
    except KeyError as e:
        return _error(e.args[0])

    if getattr(args, "img_size", None):
        recipe = dataclasses.replace(recipe, img_size=args.img_size)

    # attention-output layout: the explicit flag wins; 'auto' resolves
    # from the import-torch sidecar, so reference-trained checkpoints
    # evaluate and serve with the layout their weights were trained under
    layout = args.attn_output_layout
    if layout == "auto":
        if args.cmd == "import-torch":
            layout = "literal_view"   # provenance: a reference .pth
        else:
            meta = ckpt_lib.read_import_meta(args.workdir,
                                             recipe.checkpoint_name)
            layout = (meta or {}).get("attn_output_layout", "transpose")
    if layout != recipe.attn_output_layout:
        recipe = dataclasses.replace(recipe, attn_output_layout=layout)
        if layout == "literal_view":
            print("attention-output layout: literal_view "
                  "(reference-checkpoint semantics)", file=sys.stderr)

    device = args.platform or "cuda"
    if args.compute_dtype == "auto":
        args.compute_dtype = "bfloat16" if device == "cuda" else "float32"

    if args.cmd == "train":
        if args.step_timeout_abort and not args.step_timeout:
            # without a timeout no watchdog is armed — refuse rather than
            # silently run unsupervised when the operator asked for abort
            return _error("--step-timeout-abort requires --step-timeout "
                          "(no watchdog is armed without a timeout)")
        from maskunet_tpu_torch.train import loop
        result = loop.train(
            recipe, args.data_root, args.workdir,
            max_steps=args.max_steps, max_epochs=args.max_epochs,
            attn_impl=args.attn_impl, compute_dtype=args.compute_dtype,
            remat_attention=args.remat_attention, resume=args.resume,
            grad_accum=args.grad_accum,
            lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
            log_every=args.log_every, data_fraction=args.data_fraction,
            debug_nan=args.debug_nan, eval_every=args.eval_every,
            eval_max_batches=args.eval_max_batches,
            init_from=args.init_from, init_drop=tuple(args.init_drop),
            cache_examples=not args.no_cache,
            step_timeout=args.step_timeout,
            step_timeout_abort=args.step_timeout_abort,
            profile_dir=args.profile_dir,
            profile_steps=args.profile_steps, device=device)
        print(json.dumps({
            "recipe": recipe.name,
            "best_loss": result.best_loss,
            "best_iou": result.best_iou,
            "images_per_sec": result.images_per_sec,
        }))
        return 0

    if args.cmd == "evaluate":
        from maskunet_tpu_torch.tasks import evaluators
        from maskunet_tpu_torch.tasks.datasets import make_datasets
        from maskunet_tpu_torch.train import loop

        _, _, num_classes = make_datasets(recipe, args.data_root)
        _, ts = _state(args, recipe, num_classes, device)
        ts = ckpt_lib.restore_inference(_checkpoint(args, recipe), ts)
        kw = dict(max_batches=args.max_batches, attn_impl=args.attn_impl,
                  compute_dtype=args.compute_dtype, device=device)
        if args.mode == "semantic":
            metrics = loop.evaluate(recipe, args.data_root, ts, **kw)
            print(json.dumps({"recipe": recipe.name, **metrics}))
        elif args.mode == "instances":
            results = evaluators.evaluate_instances(
                recipe, args.data_root, ts,
                max_queries=(tuple(args.max_queries)
                             if args.max_queries else None),
                split=args.split, **kw)
            print(json.dumps({"recipe": recipe.name,
                              "instances": {str(k): v for k, v in
                                            results.items()}}))
        else:
            out = evaluators.evaluate_panoptic(
                recipe, args.data_root, ts, export_dir=args.export_dir,
                **kw)
            print(json.dumps({"recipe": recipe.name, **out}))
        return 0

    if args.cmd == "visualize":
        import numpy as np

        from maskunet_tpu_torch.data import pipeline
        from maskunet_tpu_torch.tasks.datasets import make_datasets
        from maskunet_tpu_torch.train import step as step_lib
        from maskunet_tpu_torch.utils import visualize

        _, val_ds, num_classes = make_datasets(recipe, args.data_root)
        cfg, ts = _state(args, recipe, num_classes, device)
        if os.path.exists(_checkpoint(args, recipe)):
            ts = ckpt_lib.restore_inference(_checkpoint(args, recipe), ts)
        os.makedirs(args.out, exist_ok=True)
        example = val_ds[args.index]
        visualize.save_sample(example, os.path.join(args.out, "sample.png"))
        eval_step = step_lib.make_eval_step(cfg, recipe.task_config,
                                            device=device)
        batch = pipeline.to_device(
            {k: np.repeat(v[None], recipe.batch_size, axis=0)
             for k, v in example.items()}, device)
        result = eval_step(ts, batch)
        visualize.save_prediction(
            example["image"], example["label"],
            result["pred"].cpu().numpy()[0],
            os.path.join(args.out, "prediction.png"))
        print(json.dumps({"saved": [os.path.join(args.out, "sample.png"),
                                    os.path.join(args.out,
                                                 "prediction.png")]}))
        return 0

    if args.cmd == "predict":
        from maskunet_tpu_torch.tasks import predict as predict_lib

        num_classes = _num_classes(args, recipe)
        _, ts = _state(args, recipe, num_classes, device)
        ts = ckpt_lib.restore_inference(_checkpoint(args, recipe), ts)
        written = predict_lib.predict_directory(
            recipe, ts, args.images, args.out, num_classes=num_classes,
            attn_impl=args.attn_impl, compute_dtype=args.compute_dtype,
            save_panels=args.panels, save_instances=args.instances,
            save_panoptic=args.panoptic, device=device)
        print(json.dumps({"written": len(written), "out": args.out}))
        return 0

    if args.cmd == "export":
        from maskunet_tpu_torch import export as export_lib

        platforms = args.platforms.split(",") if args.platforms else None
        try:
            export_lib.artifact_platform(platforms, device)
        except ValueError as e:
            return _error(str(e))
        out = export_lib.export_serving_artifact(
            recipe, _num_classes(args, recipe), args.workdir, args.tag,
            args.out, attn_impl=args.attn_impl,
            compute_dtype=args.compute_dtype, batch_size=args.batch_size,
            platforms=platforms, quantize=args.quantize,
            calibrate_images=args.calibrate_images, device=device)
        print(json.dumps({"exported": out,
                          "bytes": os.path.getsize(
                              os.path.join(out, export_lib.MODULE_NAME))}))
        return 0

    if args.cmd == "import-torch":
        import torch

        from maskunet_tpu_torch.utils import torch_import

        num_classes = _num_classes(args, recipe)
        cfg, ts = _state(args, recipe, num_classes, device)
        sd = torch_import.load_torch_checkpoint(args.torch_checkpoint)
        params, mstate, report = torch_import.convert_state_dict(
            sd, ts.params, ts.model_state, embed_dim=cfg.embed_dim,
            with_boundary_head=cfg.with_boundary_head)
        if report["unexpected"]:
            print(f"warning: unmapped checkpoint keys: "
                  f"{report['unexpected']}", file=sys.stderr)
        with torch.no_grad():
            for k, p in ts.params.items():
                p.copy_(params[k])
            for k, s in ts.model_state.items():
                s.copy_(mstate[k])
        # both tags, written before returning: evaluate/predict/serve
        # default to 'best', resume and --init-from read 'latest'
        manager = ckpt_lib.CheckpointManager(args.workdir,
                                             recipe.checkpoint_name)
        path = manager.save_best(ts)
        manager.save_latest(ts)
        manager.wait()
        # provenance sidecar: evaluate/predict/serve/export resolve
        # --attn-output-layout=auto from this
        ckpt_lib.write_import_meta(
            args.workdir, recipe.checkpoint_name,
            {"attn_output_layout": recipe.attn_output_layout,
             "source": args.torch_checkpoint})
        print(json.dumps({"imported": args.torch_checkpoint,
                          "checkpoint": path,
                          "attn_output_layout": recipe.attn_output_layout,
                          "ignored_keys": len(report["ignored"])}))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
