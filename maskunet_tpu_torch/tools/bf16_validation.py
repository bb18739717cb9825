"""bf16 against f32 end-to-end training on the card.

Counterpart of tools/bf16_validation.py: trains the synthetic_panoptic
recipe (lr 3e-3) twice through the port's `train.loop.train`, at
compute_dtype float32 and at bfloat16, with the same seeds and data,
then evaluates each final state: mIoU (`train.loop.evaluate`, JAX's
`evaluate_semantic`) and PQ, PQ Things and AP (`tasks.evaluators.
evaluate_panoptic`). The claim under test: bf16, the card's throughput
configuration, reaches f32's accuracy, so the throughput and the accuracy
the port reports come from the same configuration.

    python -m maskunet_tpu_torch.tools.bf16_validation [epochs] [img_size]
        [--device cuda|cpu]

Prints one JSON line {"f32": row, "bf16": row}, a line a metric, and
`bf16 parity: PASS|FAIL` by JAX's one-sided gate (`parity_ok`). The
port's rows are recorded in PERF.md. A host without CUDA is refused
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile

# bf16 may fall this far below f32 (one-sided: above f32 is no failure)
TOLERANCE = {"pq": 0.03, "miou": 0.03, "ap": 0.04}


def parity_ok(f32: dict, bf16: dict) -> bool:
    """JAX's gate: bf16's PQ and mIoU within 0.03 below f32's, its AP
    within 0.04 below; bf16 above f32 passes."""
    return all(bf16[k] >= f32[k] - tol for k, tol in TOLERANCE.items())


def run(dtype: str, epochs: int, img: int, *, device: str = "cuda") -> dict:
    from maskunet_tpu_torch.tasks import evaluators, recipes as recipes_lib
    from maskunet_tpu_torch.train import loop

    rec = dataclasses.replace(recipes_lib.get("synthetic_panoptic"),
                              img_size=img, lr=3e-3)
    workdir = tempfile.mkdtemp(prefix=f"bf16val_{dtype}_")
    try:
        res = loop.train(rec, None, workdir, max_epochs=epochs, log_every=0,
                         verbose=False, compute_dtype=dtype,
                         save_checkpoints=False, device=device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    sem = loop.evaluate(rec, None, res.state, device=device)
    pan = evaluators.evaluate_panoptic(rec, None, res.state, device=device)
    return {
        "dtype": dtype,
        "train_loss": round(res.history[-1]["loss"], 4),
        "miou": round(sem["miou"], 4),
        "pq": round(pan["pq"]["All"]["pq"], 4),
        "pq_things": round(pan["pq"]["Things"]["pq"], 4),
        "ap": round(pan["ap"]["AP"], 4),
        "images_per_sec": round(res.images_per_sec, 1),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="bf16_validation")
    ap.add_argument("epochs", type=int, nargs="?", default=30)
    ap.add_argument("img_size", type=int, nargs="?", default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("bf16_validation", args.device)
    f32 = run("float32", args.epochs, args.img_size, device=args.device)
    bf16 = run("bfloat16", args.epochs, args.img_size, device=args.device)
    print(json.dumps({"f32": f32, "bf16": bf16}))
    for k in ("miou", "pq", "ap"):
        print(f"{k}: f32={f32[k]} bf16={bf16[k]} "
              f"delta={bf16[k] - f32[k]:+.4f}")
    ok = parity_ok(f32, bf16)
    print("bf16 parity:", "PASS" if ok else "FAIL")
    return {"f32": f32, "bf16": bf16, "ok": ok}


if __name__ == "__main__":
    main()
