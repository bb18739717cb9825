"""MaskAttn-UNet (`maskunet_tpu_torch.models.maskattn_unet`): the port's
train state and step from the seeded weights, masks and dropout generator,
its FLOPs and attention bounds over those masks (`harness/flops.py`), and
the plain reference's three steps (`reference/`) from the same."""

from __future__ import annotations

import torch

from perfbench.harness import flops, weights
from perfbench.harness.training import Built
from perfbench.reference import train as ref_train
from perfbench.reference.model import ATTN_CHANNELS

FIXED = {"model": "MaskAttn-UNet", "c_in": 3,
         "attention_channels": list(ATTN_CHANNELS),
         "attn_output_layout": "transpose"}


def training(cell: dict, seed: int, device) -> Built:
    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.ops import flash_kernels as fk
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib

    cfg_file, p = cell["config"], cell["params"]
    img, batch = p["img_size"], p["batch"]
    loss = cfg_file["loss"]
    cfg = mu.MaskAttnUNetConfig(
        c_in=cfg_file["c_in"], c_out=cfg_file["c_out"], img_size=img,
        embed_dim=cfg_file["embed_dim"],
        with_boundary_head=cfg_file["with_boundary_head"],
        dropout_rate=cfg_file["dropout_rate"],
        attn_impl=cfg_file["attn_impl"],
        compute_dtype=cfg_file["compute_dtype"],
        attn_output_layout=cfg_file["attn_output_layout"])
    task = step_lib.TaskConfig(
        ce_weight=loss["ce_weight"], triplet_weight=loss["triplet_weight"],
        triplet_features=("logits" if loss["triplet_features"] == "semantic"
                          else loss["triplet_features"]),
        ignore_index=loss["ignore_index"],
        triplet_ignore_label=loss["triplet_ignore_label"],
        triplet_samples=loss["triplet_samples"], mask_policy="cached")
    params0, mstate = weights.make_weights(cfg_file, img, seed, device)
    masks = weights.make_masks(img, batch, seed, device,
                               cfg_file["attention_key_density"])
    opt = loop_lib.AdamW(cfg_file["optimizer"]["lr"],
                         cfg_file["optimizer"]["weight_decay"])
    gen = torch.Generator(device=device).manual_seed(
        weights.dropout_seed(seed))
    ts = state_lib.create(gen, params0, mstate, opt, masks=masks)
    step = step_lib.make_train_step(
        cfg, task, mask_plans=mu.precompute_mask_plans(ts.masks),
        device=device)

    def reference(batches, *, quant=None, half_batch=False):
        gen = torch.Generator(device=device).manual_seed(
            weights.dropout_seed(seed))
        return ref_train.train_steps(params0, batches, masks, gen, cfg_file,
                                     quant=quant, half_batch=half_batch)

    # without a triplet term the step takes no instance ids
    keys = ("image", "label") + (("instance",) if task.triplet_weight
                                 else ())
    return Built(
        state=ts, step=step, params0=params0, classes=cfg_file["c_out"],
        pool_keys=keys,
        flops_per_call=flops.model_flops(img, cfg_file, masks)["train"],
        bounds=flops.attention_bounds(masks),
        counters={"K1": fk.flash_fwd_nomax, "K2": fk.flash_fwd_nomax_lse,
                  "K4": fk.flash_bwd},
        reference=reference)
