"""Trace the inference forward and the train step on the card, then print
per-op device timings through `parse_xplane`.

Counterpart of tools/profile_step.py:

    python -m maskunet_tpu_torch.tools.profile_step [batch] [out_dir] [steps]
        [--img N] [--device cuda|cpu]

Defaults: batch 8, a new temporary directory, 3 traced calls of each
phase, 128 px. The configuration is the JAX tool's: the ADE model (c_out
150, bf16), BN folded and cast for the inference forward, the cached masks
with precomputed plans, and the train step with AdamW 5e-5 / decay 0.1.
Each phase is warmed and then traced on its own (`fwd/`, `train/`, each
a `trace.json` of `utils/profiling.trace`); a subprocess parses each
directory. A host without CUDA is refused unless `--device cpu` is given
(the CPU runs the kernels' plain versions, and its trace has no device
events).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

# the checkout's root, where `python -m maskunet_tpu_torch...` imports
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(batch: int = 8, out_dir: str | None = None, steps: int = 3, *,
        img_size: int = 128, device: str = "cuda") -> dict:
    """Warms and traces the forward (`steps` calls into `out_dir/fwd`),
    then the train step (`out_dir/train`). Returns the two directories,
    each phase's flash-kernel launches over its traced calls, and the two
    calls themselves (`calls`: the forward, and one step that returns its
    loss) for a caller that times them again."""
    import numpy as np
    import torch

    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.ops import flash_kernels as fk
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib
    from maskunet_tpu_torch.utils import profiling

    dev = resolve_device(device)
    out_dir = os.path.abspath(out_dir
                              or tempfile.mkdtemp(prefix="torchtrace_"))
    img = img_size
    cfg = mu.MaskAttnUNetConfig(c_out=150, img_size=img,
                                compute_dtype="bfloat16")
    params, mstate = mu.init(torch.Generator().manual_seed(0), cfg)
    params = {k: v.to(dev) for k, v in params.items()}
    mstate = {k: v.to(dev) for k, v in mstate.items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, img, img, 3)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 150, (batch, img, img))).to(dev)
    masks = tuple(m.to(dev) for m in mu.make_attention_masks(
        torch.Generator().manual_seed(1), batch, img))
    with torch.no_grad():
        p_fold = mu.cast_params_for_inference(
            mu.fold_bn_for_inference(params, mstate, cfg))
    mask_plans = mu.precompute_mask_plans(masks)

    def fwd():
        with torch.no_grad():
            out, _ = mu.apply(p_fold, None, x, cfg=cfg, masks=masks,
                              train=False, folded=True,
                              mask_plans=mask_plans)
        return out.semantic

    ts = state_lib.create(torch.Generator(device=dev).manual_seed(2),
                          params, mstate, loop_lib.AdamW(5e-5, 1e-1),
                          masks=masks)
    del params, mstate
    train_step = step_lib.make_train_step(cfg, step_lib.TaskConfig(),
                                          mask_plans=mask_plans, device=dev)
    batch_data = {"image": x, "label": labels}

    def step():
        return train_step(ts, batch_data)[1]["loss"]

    kernels = {"K1": fk.flash_fwd_nomax, "K2": fk.flash_fwd_nomax_lse,
               "K3": fk.flash_fwd_online, "K4": fk.flash_bwd}

    def traced(name, call, fence):
        """Warm `call`, then trace `steps` calls of it into out_dir/name;
        returns the directory and the launches of the traced calls."""
        path = os.path.join(out_dir, name)
        os.makedirs(path, exist_ok=True)
        fence(call())
        before = {k: fn.launches for k, fn in kernels.items()}
        with profiling.trace(path):
            for _ in range(steps):
                out = call()
            fence(out)
        return path, {k: fn.launches - before[k] for k, fn in kernels.items()}

    # warm then trace strictly per phase, as the JAX tool does
    fwd_dir, fwd_launches = traced("fwd", fwd, lambda o: float(o[0, 0, 0, 0]))
    train_dir, train_launches = traced("train", step, float)
    return {"out_dir": out_dir, "fwd": fwd_dir, "train": train_dir,
            "steps": steps,
            "launches": {"fwd": fwd_launches, "train": train_launches},
            "calls": {"fwd": fwd, "train": step}}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="profile_step")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("steps", type=int, nargs="?", default=3)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("profile_step", args.device)
    res = run(args.batch, args.out_dir, args.steps, img_size=args.img,
              device=args.device)
    print(f"traces written to {res['out_dir']}; parsing...", flush=True)
    for d in (res["fwd"], res["train"]):
        print(f"-- {os.path.basename(d)} --", flush=True)
        subprocess.run([sys.executable, "-m",
                        "maskunet_tpu_torch.tools.parse_xplane", d,
                        str(args.steps)], check=False, cwd=_ROOT)
    return res


if __name__ == "__main__":
    main()
