"""Model export: self-contained serving artifacts (`torch.export`).

Counterpart of maskunet_tpu/export.py. `export_serving_artifact` freezes
the exact folded serving computation of `serve.build_inference_fn` (BN
folded, pre-cast, optionally int8, with the fixed serving masks and their
compaction plans as one pair) into a `torch.export` program whose weights,
masks and plans are buffers inside it. `load_serving_artifact` turns it
back into the `runner(images_uint8) -> class_maps` callable that
`serve.main` uses, and `python -m maskunet_tpu_torch.serve --artifact
<dir>` serves straight from it.

Artifact layout (a directory):
    model.pt2   `torch.export.save` of the program, weights included
    meta.json   recipe / img_size / num_classes / batch_size / dtypes, with
                the JAX package's keys

Two divergences from JAX's artifact, by design:
- The attention runs the port's operators `maskunet::flash_fwd_nomax` (K1)
  or, exported under MASKUNET_SAFE_SOFTMAX=1, `maskunet::flash_fwd_online`
  (K3). Loading needs them registered: `load_serving_artifact` imports
  `ops.flash_kernels` first, so a loader needs this package, not only
  torch.
- A program is tied to the device it was traced on. `platforms` (JAX's
  list of lowering targets) is therefore one of 'cuda' / 'cpu', the
  device of the export; a list of several is refused.

The input is uint8 [B, H, W, 3] on that device; the copy from the host
stays outside the artifact, in the runner.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from maskunet_tpu_torch import serve
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.ops import flash_attention as fa

META_NAME = "meta.json"
MODULE_NAME = "model.pt2"


def artifact_platform(platforms, device: str | torch.device) -> str:
    """The artifact's device type: `device`'s, which `platforms` (JAX's
    lowering targets), when given, must name alone."""
    kind = torch.device(device).type
    if platforms is not None:
        platforms = list(platforms)
        if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
            raise ValueError(
                f"platforms {platforms}: a torch export artifact runs only "
                "on the device it was traced on; give one of 'cuda' or "
                "'cpu'")
        if platforms[0] != kind:
            raise ValueError(f"platforms {platforms} but the export runs "
                             f"on {kind}")
    return kind


class _ServingModule(torch.nn.Module):
    """`serve.classify` on buffers: the folded weights, the serving masks
    and their compaction plans travel inside the program."""

    def __init__(self, infer_params: dict, masks: tuple, plans: tuple,
                 cfg: mu.MaskAttnUNetConfig):
        super().__init__()
        self.cfg = cfg
        self.param_keys = tuple(infer_params)
        # own storage for each buffer: a view (a plan's index slice)
        # would save the whole tensor it views
        for i, k in enumerate(self.param_keys):
            self.register_buffer(f"param{i}",
                                 infer_params[k].detach().clone())
        for i, m in enumerate(masks):
            self.register_buffer(f"mask{i}", m.clone())
        self.plan_layers = tuple(i for i, p in enumerate(plans)
                                 if p is not None)
        for i in self.plan_layers:
            for field, t in plans[i]._asdict().items():
                self.register_buffer(f"plan{i}_{field}", t.clone())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        params = {k: getattr(self, f"param{i}")
                  for i, k in enumerate(self.param_keys)}
        masks = tuple(getattr(self, f"mask{i}") for i in range(6))
        plans = tuple(
            fa.CompactPlan(*(getattr(self, f"plan{i}_{f}")
                             for f in fa.CompactPlan._fields))
            if i in self.plan_layers else None for i in range(6))
        return serve.classify(params, masks, plans, self.cfg, images)


def export_serving_artifact(recipe, num_classes: int, workdir: str | None,
                            tag: str, out_dir: str, *,
                            attn_impl: str = "auto",
                            compute_dtype: str = "bfloat16",
                            batch_size: int | None = None,
                            platforms=None,
                            quantize: str | None = None,
                            calibrate_images: str | None = None,
                            device: str | torch.device = "cuda") -> str:
    """Export the folded serving forward for `recipe` to `out_dir`, traced
    on `device` (`platforms`: JAX's argument, at most the name of that
    device). `quantize="int8"` bakes the int8 convs in (a quarter of the
    bytes of f32 conv weights, half of bf16's), with static scales from `calibrate_images`
    where given. Returns `out_dir`."""
    from maskunet_tpu_torch.tasks import recipes as recipes_lib

    if isinstance(recipe, str):
        recipe = recipes_lib.get(recipe)
    kind = artifact_platform(platforms, device)
    _, infer_params, masks, cfg = serve.build_inference_fn(
        recipe, num_classes, workdir, tag, attn_impl=attn_impl,
        compute_dtype=compute_dtype, batch_size=batch_size,
        quantize=quantize, calibrate_images=calibrate_images, device=device)
    batch = masks[0].shape[0]
    module = _ServingModule(infer_params, masks,
                            mu.precompute_mask_plans(masks), cfg)
    example = torch.zeros(batch, cfg.img_size, cfg.img_size, 3,
                          dtype=torch.uint8, device=device)
    with torch.no_grad():
        program = torch.export.export(module, (example,))

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, MODULE_NAME))
    meta = {
        "recipe": recipe.name,
        "img_size": cfg.img_size,
        "num_classes": num_classes,
        "batch_size": batch,
        "compute_dtype": compute_dtype,
        "quantize": quantize,
        "calibrated": bool(calibrate_images),
        "attn_impl": cfg.resolve_attn_impl(),
        "platforms": [kind],
        "input_shape": [batch, cfg.img_size, cfg.img_size, 3],
        "output": "uint8 class-id map [batch, img_size, img_size]",
    }
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_serving_artifact(path: str):
    """Load an exported artifact. Returns (runner, meta), with
    `serve.build_model_runner`'s contract: `runner(images_uint8
    [B,H,W,3])` copies the images to the artifact's device and returns
    the class maps there, without waiting for them."""
    from maskunet_tpu_torch.ops import flash_kernels  # noqa: F401 — the ops

    with open(os.path.join(path, META_NAME)) as f:
        meta = json.load(f)
    device = torch.device(meta["platforms"][0])
    module = torch.export.load(os.path.join(path, MODULE_NAME)).module()

    @torch.no_grad()
    def runner(images) -> torch.Tensor:
        x = torch.as_tensor(np.ascontiguousarray(images, np.uint8))
        return module(x.to(device))

    return runner, meta


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a checkpoint as a self-contained serving "
                    "artifact (torch.export; it runs on the device it was "
                    "exported on and needs this package's flash operators "
                    "to load)")
    ap.add_argument("--recipe", required=True)
    ap.add_argument("--workdir", default="runs")
    ap.add_argument("--tag", default="best")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--num-classes", type=int, required=True)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "dense", "flash"])
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--quantize", default=None, choices=["int8"])
    ap.add_argument("--calibrate-images", default=None,
                    help="with --quantize int8: sample-image dir for "
                         "static activation scales")
    ap.add_argument("--platforms", default=None,
                    help="the one device to export for, --platform's (a "
                         "torch artifact runs only on the device it was "
                         "exported on, so a list of several is refused)")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the device to trace on (default: the card)")
    args = ap.parse_args(argv)

    platforms = args.platforms.split(",") if args.platforms else None
    try:
        artifact_platform(platforms, args.platform)
    except ValueError as e:
        ap.error(str(e))
    out = export_serving_artifact(
        args.recipe, args.num_classes, args.workdir, args.tag, args.out,
        attn_impl=args.attn_impl, compute_dtype=args.compute_dtype,
        batch_size=args.batch_size, platforms=platforms,
        quantize=args.quantize, calibrate_images=args.calibrate_images,
        device=args.platform)
    with open(os.path.join(out, META_NAME)) as f:
        print(f.read())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
