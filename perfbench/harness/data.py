"""Seeded inputs: the repository's synthetic rectangles, frozen here.

A copy of `maskunet_tpu_torch/data/synthetic.py`'s example (kept apart so
that a change to the program cannot change the inputs): `num_objects`
axis-aligned rectangles of random classes over a background, each class
with its own colour, Gaussian noise of sigma 8 on the image, instance ids
1..num_objects (0 the background), and with `ignore_border` the label of
the top two rows set to 255. Example i of a run with seed s is drawn from
numpy's generator at s * 100003 + i, so every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np


def example(seed: int, idx: int, *, img_size: int, num_classes: int,
            num_objects: int, ignore_border: bool = False,
            palette_seed: int = 1234) -> dict[str, np.ndarray]:
    colors = np.random.default_rng(palette_seed).integers(
        0, 256, (num_classes, 3)).astype(np.uint8)
    rng = np.random.default_rng(seed * 100003 + idx)
    s = img_size
    sem = np.zeros((s, s), np.int32)
    inst = np.zeros((s, s), np.int32)
    img = np.zeros((s, s, 3), np.float32) + colors[0]
    for obj in range(1, num_objects + 1):
        cls = int(rng.integers(1, num_classes))
        h = int(rng.integers(s // 8, s // 2))
        w = int(rng.integers(s // 8, s // 2))
        y = int(rng.integers(0, s - h))
        x = int(rng.integers(0, s - w))
        sem[y:y + h, x:x + w] = cls
        inst[y:y + h, x:x + w] = obj
        img[y:y + h, x:x + w] = colors[cls]
    img += rng.normal(0, 8, img.shape)
    if ignore_border:
        sem[:2, :] = 255
    return {"image": np.clip(img, 0, 255).astype(np.uint8), "label": sem,
            "instance": inst}


def pool(seed: int, n: int, **kw) -> dict[str, np.ndarray]:
    """n examples stacked: image uint8 [n, H, W, 3], label and instance
    int64 [n, H, W]."""
    ex = [example(seed, i, **kw) for i in range(n)]
    return {k: np.stack([e[k] for e in ex]).astype(
        np.uint8 if k == "image" else np.int64) for k in ex[0]}
