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

Parallelism, with JAX's meanings (`maskunet_tpu_torch.parallel`):
- `--n-data N` (train, evaluate): data parallelism over N devices, one
  process each: this command starts N local ranks with a local TCP
  rendezvous (gloo processes on the CPU with `--platform cpu`, NCCL on N
  cards otherwise; a host with fewer cards exits 2). Only rank 0 prints.
  The recipe's batch must divide by N (exit 2 otherwise).
- `--pipeline M` (train): the 2-stage GPipe over the first two cards
  (exit 2 on a host with fewer; with `--platform cpu` both stages run on
  the CPU); with `--n-data N`, dp x pp over N pairs of cards.
- `--distributed`: this process is one rank of a job its launcher
  started: `--coordinator host:port`, `--num-processes` and `--process-id`
  (or the launcher's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK), one card a
  process (LOCAL_RANK); `--n-data` defaults to the number of processes.

What differs from the JAX CLI:
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
import contextlib
import json
import os
import socket
import sys


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
                   help="data-parallel mesh size: N ranks, one device each "
                        "(train, evaluate)")
    p.add_argument("--platform", default=None, choices=["cuda", "cpu"],
                   help="the torch device (default: cuda, the card; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: join the process group of a job "
                        "started by a launcher before device/mesh setup")
    p.add_argument("--coordinator", default=None,
                   help="with --distributed: rendezvous address "
                        "(host:port); omit to read the launcher's "
                        "MASTER_ADDR / MASTER_PORT")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --distributed: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --distributed: this process's index")


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
                    help="pipeline parallelism: run M >= 2 microbatches of "
                         "batch_size per step through the 2-stage GPipe "
                         "(encoder | decoder over the first two cards); "
                         "one global loss and optimizer update per step. "
                         "Composes with --n-data N (a data x pipe mesh "
                         "over N*2 cards) and with --grad-accum K "
                         "(K accumulated flushes per optimizer update)")
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


def _mesh_device(mesh) -> str:
    """The device this process runs the command on: its rank's (its first
    stage's under the pipeline)."""
    from maskunet_tpu_torch.parallel.pipeline import PipeMesh
    return str(mesh.devices[0] if isinstance(mesh, PipeMesh)
               else mesh.device)


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

    if args.cmd == "train" and args.step_timeout_abort \
            and not args.step_timeout:
        # without a timeout no watchdog is armed — refuse rather than
        # silently run unsupervised when the operator asked for abort
        return _error("--step-timeout-abort requires --step-timeout "
                      "(no watchdog is armed without a timeout)")

    if args.n_data is not None and recipe.batch_size % args.n_data != 0:
        # DP preflight: the global batch is split over the data axis, so it
        # must divide evenly — fail here with a one-line message
        # (city_semantic/city_panoptic have batch 1)
        return _error(f"recipe '{recipe.name}' batch_size="
                      f"{recipe.batch_size} is not divisible by --n-data="
                      f"{args.n_data}; pick --n-data that divides the batch "
                      "(or a recipe with a larger batch)")
    pipeline = getattr(args, "pipeline", 1)
    if args.distributed:
        # this process is one rank of a job its launcher started
        return _as_rank(args, recipe, device, args.coordinator,
                        args.num_processes, args.process_id)
    if args.n_data is not None and args.cmd in _PARALLEL_CMDS:
        return _local_ranks(args, recipe, device)
    mesh = None
    if pipeline > 1:
        from maskunet_tpu_torch.parallel import pipeline as pp_lib
        try:
            mesh = pp_lib.make_pipe_mesh(
                devices=["cpu", "cpu"] if device == "cpu" else None)
        except ValueError as e:
            return _error(f"--pipeline {pipeline}: {e}")
    return _command(args, recipe, device, mesh)


# the subcommands that run on a mesh (JAX's CLI passes its mesh to these)
_PARALLEL_CMDS = ("train", "evaluate")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_mesh(args, device: str):
    """This rank's mesh in an initialised process group: the data mesh, or
    with `--pipeline M` the dp x pp mesh; on the CPU every rank's devices
    are the CPU."""
    import torch.distributed as dist

    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    n = args.n_data or dist.get_world_size()
    if getattr(args, "pipeline", 1) > 1:
        from maskunet_tpu_torch.parallel import pipeline as pp_lib
        return pp_lib.make_dp_pipe_mesh(
            n, devices=["cpu"] * (2 * n) if device == "cpu" else None)
    return mesh_lib.make_mesh(n, devices=["cpu"] * n if device == "cpu"
                              else None)


def _run_rank(args, recipe, device: str) -> int:
    """The command on this rank's mesh; only rank 0 prints its result."""
    import torch.distributed as dist
    try:
        mesh = _rank_mesh(args, device)
    except ValueError as e:
        return _error(str(e))
    out = (contextlib.nullcontext() if dist.get_rank() == 0
           else contextlib.redirect_stdout(open(os.devnull, "w")))
    with out:
        return _command(args, recipe, device, mesh)


def _as_rank(args, recipe, device: str, coordinator, n: int | None,
             rank: int | None) -> int:
    """Joins the process group (gloo on the CPU, NCCL on the card), runs
    the command as this rank, and leaves the group."""
    import torch.distributed as dist

    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.init_distributed(coordinator, n, rank,
                              "gloo" if device == "cpu" else "nccl")
    try:
        return _run_rank(args, recipe, device)
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, args, recipe, device: str, port: int) -> None:
    """A local rank started by `_local_ranks` (a spawned process)."""
    import torch
    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cpu":
        torch.set_num_threads(1)   # N ranks share the host's cores
    code = _as_rank(args, recipe, device, f"localhost:{port}", args.n_data,
                    rank)
    if code:
        sys.exit(code)


def _local_ranks(args, recipe, device: str) -> int:
    """`--n-data N` without `--distributed`: N local ranks, one device
    each, as processes of `torch.multiprocessing` meeting at a local TCP
    rendezvous; a single rank runs in this process."""
    n = args.n_data
    if device == "cuda":
        import torch
        need = n * (2 if getattr(args, "pipeline", 1) > 1 else 1)
        count = torch.cuda.device_count()
        if count < need:
            return _error(f"--n-data {n} needs {need} CUDA devices, this "
                          f"host has {count}")
    if n == 1:
        return _as_rank(args, recipe, device, f"localhost:{_free_port()}",
                        1, 0)
    import torch.multiprocessing as mp
    sys.stdout.flush()
    try:
        mp.start_processes(_rank_main, args=(args, recipe, device,
                                             _free_port()),
                           nprocs=n, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        return e.exit_code if e.exit_code and e.exit_code > 0 else 1
    except mp.ProcessRaisedException as e:
        print(f"error: a rank failed: {e}", file=sys.stderr)
        return 1
    return 0


def _command(args, recipe, device: str, mesh) -> int:
    """The subcommand's work on `device` (this rank's, under a process
    group), with `mesh` where it runs on one."""
    from maskunet_tpu_torch.core import checkpoint as ckpt_lib
    if mesh is not None:
        device = _mesh_device(mesh)
    pipeline = getattr(args, "pipeline", 1)
    if args.cmd == "train":
        from maskunet_tpu_torch.train import loop
        result = loop.train(
            recipe, args.data_root, args.workdir,
            max_steps=args.max_steps, max_epochs=args.max_epochs,
            mesh=mesh, attn_impl=args.attn_impl,
            compute_dtype=args.compute_dtype,
            remat_attention=args.remat_attention, resume=args.resume,
            grad_accum=args.grad_accum, pipeline_microbatches=pipeline,
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
                  compute_dtype=args.compute_dtype, device=device,
                  mesh=mesh)
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
