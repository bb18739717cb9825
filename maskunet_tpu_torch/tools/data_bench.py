"""Host input-pipeline throughput: decode -> resize -> batch -> card.

Counterpart of tools/data_bench.py: what the threaded pipeline
(`data/pipeline.py`: `BatchIterator` behind the `Prefetcher`) sustains
end to end into device memory, on a real-layout dataset on disk (fake, with
the decode path of real data):

    python -m maskunet_tpu_torch.tools.make_fake_dataset ade <root> --n 256
    python -m maskunet_tpu_torch.tools.data_bench [root] [batch] [epochs]
        [--device cuda|cpu]

A missing root is made with `make_fake_dataset ade --n 256`. Prints one
JSON line per thread count (1, 4, 8, 16) with the JAX tool's keys: images
a second from disk into the card's memory (the uint8 batches become
f32/255 on the card). The prefetcher copies on a stream of its own, so the
fence after the last batch is `torch.cuda.synchronize()`. A host without
CUDA is refused unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

THREADS = (1, 4, 8, 16)
# the checkout's root, where `python -m maskunet_tpu_torch...` imports
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(root: str, batch: int = 8, epochs: int = 4,
        threads: tuple = THREADS, *, device: str = "cuda") -> list[dict]:
    """One row per thread count: a warm epoch, then `epochs` timed epochs.
    Each row carries the JAX tool's keys and, beside them, the images the
    timed epochs delivered (`images`, not printed)."""
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.data import pipeline
    from maskunet_tpu_torch.data.ade20k import ADE20KSemanticDataset

    dev = resolve_device(device)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ds = ADE20KSemanticDataset(root, "training", img_size=128)
    n = len(ds)
    if n < batch:
        raise SystemExit(
            f"dataset at {root} has {n} images < batch {batch} "
            "(drop_last=True yields zero batches); use a smaller batch "
            "or point at a larger dataset")
    rows = []
    for t in threads:
        batches = pipeline.BatchIterator(ds, batch, shuffle=True, seed=0,
                                         drop_last=True, num_threads=t)
        # warm one epoch (page cache, thread pools, device alloc)
        with pipeline.Prefetcher(batches.epoch(0), device=dev) as pf:
            for _ in pf:
                pass
        fence()
        t0 = time.perf_counter()
        images = 0
        for e in range(1, epochs + 1):
            with pipeline.Prefetcher(batches.epoch(e), device=dev) as pf:
                for b in pf:
                    images += int(b["image"].shape[0])
        fence()
        dt = time.perf_counter() - t0
        row = {
            "dataset_images": n, "batch": batch, "threads": t,
            "img_per_sec": round(images / dt, 1),
            # thread scaling is bounded by the host's core count
            "host_cores": os.cpu_count(),
        }
        print(json.dumps(row), flush=True)
        rows.append({**row, "images": images})
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="data_bench")
    ap.add_argument("root", nargs="?", default="/tmp/fake_ade_bench")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("epochs", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("data_bench", args.device)
    root = os.path.abspath(args.root)
    if not os.path.isdir(root):
        subprocess.run([sys.executable, "-m",
                        "maskunet_tpu_torch.tools.make_fake_dataset", "ade",
                        root, "--n", "256"], check=True, cwd=_ROOT)
    return run(root, args.batch, args.epochs, device=args.device)


if __name__ == "__main__":
    main()
