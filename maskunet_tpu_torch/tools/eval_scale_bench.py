"""Host-side evaluation at real-COCO scale.

Counterpart of tools/eval_scale_bench.py: ~5k images x 100+ categories of
synthetic ground-truth and detection masks (RLE), then the time of the
whole `evaluate_ap` (the COCOeval replacement) and of `pq_compute`, and
the rate of instance extraction a map. Target: the evaluation wall time a
real COCO validation run would pay, under 2 min.

    python -m maskunet_tpu_torch.tools.eval_scale_bench [n_images] [n_cats]

All host work (numpy and `csrc/maskops.cpp` through `utils/native.py`);
it runs on the card's host because that is where a training run's
evaluator runs. It prints whether the native library loaded, the JAX
tool's lines, and last its JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def synth_annotations(n_images: int, n_cats: int, size: int = 128,
                      per_img: int = 12, seed: int = 0):
    """Random rectangles as gts; dts = jittered copies + spurious extras
    (the JAX tool's draws, in its order)."""
    from maskunet_tpu_torch.evaluation import rle as rle_lib

    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for img in range(n_images):
        for _ in range(per_img):
            cat = int(rng.integers(1, n_cats + 1))
            h = int(rng.integers(8, size // 2))
            w = int(rng.integers(8, size // 2))
            y = int(rng.integers(0, size - h))
            x = int(rng.integers(0, size - w))
            m = np.zeros((size, size), np.uint8)
            m[y:y + h, x:x + w] = 1
            seg = rle_lib.encode(m)
            gts.append({"image_id": img, "category_id": cat,
                        "segmentation": seg, "area": int(m.sum())})
            # detection: jittered box, mostly same category
            dy, dx = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
            md = np.zeros((size, size), np.uint8)
            yy, xx = max(0, y + dy), max(0, x + dx)
            md[yy:yy + h, xx:xx + w] = 1
            dts.append({"image_id": img,
                        "category_id": cat if rng.random() < 0.9
                        else int(rng.integers(1, n_cats + 1)),
                        "segmentation": rle_lib.encode(md),
                        "area": int(md.sum()),
                        "score": float(rng.random())})
        # a couple of spurious detections
        for _ in range(2):
            m = np.zeros((size, size), np.uint8)
            m[:16, :16] = 1
            dts.append({"image_id": img,
                        "category_id": int(rng.integers(1, n_cats + 1)),
                        "segmentation": rle_lib.encode(m),
                        "area": 256, "score": float(rng.random() * 0.3)})
    return gts, dts


def instance_maps(n: int = 1024, seed: int = 1) -> np.ndarray:
    """`n` argmax-like 128 px maps of coherent rectangles (a trained
    model's maps, not noise: a noise map decodes to ~12k one-pixel
    instances, which no evaluator survives)."""
    rng = np.random.default_rng(seed)
    maps = np.zeros((n, 128, 128), np.int32)
    for m in maps:
        for _ in range(10):
            c = int(rng.integers(1, 20))
            h, w = int(rng.integers(8, 64)), int(rng.integers(8, 64))
            y, x = int(rng.integers(0, 128 - h)), int(rng.integers(0, 128 - w))
            m[y:y + h, x:x + w] = c
    return maps


def pq_images(n: int = 1000, seed: int = 2) -> list:
    """`n` (pan, segments, pan, segments) pairs fused from random semantic
    maps (the prediction equals the ground truth)."""
    from maskunet_tpu_torch.evaluation import panoptic

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sem = rng.integers(0, 12, (128, 128)).astype(np.int32)
        pan, segs = panoptic.semantic_to_panoptic((sem > 8) * sem)
        out.append((pan, segs, pan, segs))
    return out


def main(argv: list[str] | None = None) -> dict:
    from maskunet_tpu_torch.evaluation import coco_eval, instances, panoptic
    from maskunet_tpu_torch.utils import native

    argv = sys.argv[1:] if argv is None else argv
    n_images = int(argv[0]) if len(argv) > 0 else 5000
    n_cats = int(argv[1]) if len(argv) > 1 else 120
    print(f"native kernels: {native.available()}")

    t0 = time.perf_counter()
    gts, dts = synth_annotations(n_images, n_cats)
    print(f"synth {len(gts)} gts / {len(dts)} dts over {n_images} images "
          f"x {n_cats} cats: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    stats = coco_eval.evaluate_ap(gts, dts)
    t_ap = time.perf_counter() - t0
    print(f"evaluate_ap: {t_ap:.1f}s  AP={stats['AP']:.3f} "
          f"AP50={stats['AP50']:.3f}")

    # per-image instance extraction (connected components + RLE): the
    # prediction side's decode cost of a full validation run
    maps = instance_maps()
    t0 = time.perf_counter()
    n_inst = sum(len(instances.get_instances_from_mask(m)) for m in maps)
    t_inst = time.perf_counter() - t0
    print(f"instance extraction: {len(maps)} maps -> {n_inst} instances "
          f"in {t_inst:.1f}s ({len(maps) / t_inst:.0f} img/s)")

    # PQ at scale: fuse gt/pred panoptic maps per image
    t0 = time.perf_counter()
    stats_pq = panoptic.pq_compute(pq_images())
    t_pq = time.perf_counter() - t0
    print(f"pq_compute: 1000 images in {t_pq:.1f}s "
          f"PQ={stats_pq['All']['pq']:.3f}")

    total = t_ap + t_pq
    row = {"n_images": n_images, "n_cats": n_cats,
           "ap_seconds": round(t_ap, 1),
           "pq_1000img_seconds": round(t_pq, 1),
           "inst_extract_img_per_sec": round(len(maps) / t_inst, 1),
           "ok": total < 120}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
