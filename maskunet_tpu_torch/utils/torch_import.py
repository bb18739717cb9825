"""Import reference PyTorch checkpoints (`.pth` state_dicts), and export
back.

Counterpart of maskunet_tpu/utils/torch_import.py. The reference saves
bare `model.state_dict()` files (ade_semantic.py:344), optionally with
DataParallel `module.` prefixes (ade_semantic.py:360-368 strips them the
same way). The port's parameters are already keyed by the reference's
names (`utils.jax_weights.mapping`), in the reference's layouts, so the
import is a checked copy:

    python -m maskunet_tpu_torch.cli import-torch --recipe ade_semantic \\
        --torch-checkpoint checkpoint_ade.pth --workdir runs/imported

DownSample/UpSample `emb_layer.*` keys and BatchNorm `num_batches_tracked`
are ignored (the first is dead code in the reference forward,
ade_semantic.py:222-229); any other unmapped key is reported as
unexpected.
"""

from __future__ import annotations

import torch

from maskunet_tpu_torch.utils.jax_weights import mapping


def strip_module_prefix(sd: dict) -> dict:
    """DataParallel checkpoints prefix every key with `module.`
    (ade_semantic.py:361 strips it identically)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def convert_state_dict(sd: dict, params: dict, mstate: dict,
                       embed_dim: int = 0,
                       with_boundary_head: bool = False
                       ) -> tuple[dict, dict, dict]:
    """Reference state_dict (tensor- or numpy-valued) -> (params, mstate,
    report).

    `params` / `mstate` are the port's flat templates (`maskattn_unet.init`:
    the shape, dtype and device of each entry); returns new dicts with
    every mapped entry replaced by the checkpoint's. Raises KeyError on a
    missing key and ValueError on a shape mismatch; the report lists the
    ignored keys (`ignored`: every unused one, sorted) and of those the
    `unexpected` ones (neither a dead `emb_layer` nor
    `num_batches_tracked`), as JAX's does."""
    sd = strip_module_prefix(sd)
    out = {"params": dict(params), "mstate": dict(mstate)}
    used = set()
    for tkey, tree, path, _, _ in mapping(embed_dim, with_boundary_head):
        if tkey not in sd:
            raise KeyError(f"reference checkpoint is missing '{tkey}' "
                           f"(wanted for {'/'.join(path)})")
        tpl = out[tree][tkey]
        value = torch.as_tensor(sd[tkey])
        if tuple(value.shape) != tuple(tpl.shape):
            raise ValueError(
                f"shape mismatch for '{tkey}': checkpoint "
                f"{tuple(value.shape)} vs model {tuple(tpl.shape)} "
                f"(wrong c_out/img_size/embed_dim config?)")
        out[tree][tkey] = value.to(device=tpl.device, dtype=tpl.dtype)
        used.add(tkey)
    ignored = sorted(set(sd) - used)
    unexpected = [k for k in ignored
                  if "emb_layer" not in k
                  and not k.endswith("num_batches_tracked")]
    return out["params"], out["mstate"], {"ignored": ignored,
                                          "unexpected": unexpected}


def export_state_dict(params: dict, mstate: dict, embed_dim: int = 0,
                      with_boundary_head: bool = False) -> dict:
    """(params, mstate) -> a state_dict the reference loads (CPU tensors,
    for `torch.save`). BatchNorm num_batches_tracked is emitted as 0 —
    torch only uses it for momentum=None cumulative averaging, which the
    reference never does."""
    flat = {**params, **mstate}
    sd: dict[str, torch.Tensor] = {}
    for tkey, _, _, _, _ in mapping(embed_dim, with_boundary_head):
        sd[tkey] = flat[tkey].detach().cpu().clone()
        if tkey.endswith("running_var"):
            sd[tkey.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(0, dtype=torch.int64))
    return sd


def load_torch_checkpoint(path: str) -> dict:
    """`torch.load` a reference .pth on the CPU (tensors only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a bare state_dict "
                         f"(the reference's torch.save format)")
    return sd
