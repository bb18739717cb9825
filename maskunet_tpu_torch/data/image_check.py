"""A fixed set of decodes and resizes, and the digests of their results.

The readers decode and resize through cv2 (`data/resize.py`), whose
version differs between hosts. This module runs the same work on any host
and returns a sha256 per result, so two hosts can be compared without
moving the arrays:

- `scene.jpg` (a 64x48 RGB scene of the fake-dataset painter, JPEG
  quality 95) decoded to RGB, and resized INTER_LINEAR to 128x128;
- `labels.png` (an 8-bit class-id map) decoded as grayscale;
- `instance_ids.png` (a 16-bit Cityscapes-style `class * 1000 + id` map)
  decoded with IMREAD_UNCHANGED, and resized INTER_NEAREST to 128x128 as
  int32, as the Cityscapes reader does;
- a seeded uint8 image resized INTER_LINEAR to 128x128, from 80x96 (up)
  and from 260x300 (down), and a seeded uint8 id map resized
  INTER_NEAREST to 128x128.

The three files sit beside this module. `EXPECTED` holds the digests
that cv2 5.0.0 gives on an x86 CPU host.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from maskunet_tpu_torch.data import resize

FILES = Path(__file__).resolve().parent / "image_check"
SIZE = 128
SEED = 11

EXPECTED = {
    "jpeg_rgb":
        "069e4d912ddc2487562ce1c70376b588705669df1b47e0b57ebad359e3acf18e",
    "jpeg_linear":
        "25e4020e653c3842d08068a97e978cc54da9cb6306c1c9028273254762d03c21",
    "png8_gray":
        "2426289212908cbcfe62640fad1eb1f245c0a376e62b14d2ea63751a6b20ebaa",
    "png16_unchanged":
        "8d9372401b9295103d865c27210a5a4bec72fc2ebb13b857a39e539cb7ea21fb",
    "png16_nearest":
        "6d5f0b099f2638243527b0e7aeed0c9423a2d20905b790a8057f66a5be51d756",
    "seeded_linear_up":
        "86a9234e9709d2d548b44d20670e2fc229dadba2e63b12b4de4c8f80ce23b334",
    "seeded_linear_down":
        "757a507653ae7e45a832724ee85ce752fa4ba2eda0cfc487748653c928d064f3",
    "seeded_nearest":
        "19947f7eddb78a158d3fc1ffb11076f3e71a1f9f79181d9bcc22f189b51b4430",
}


def digest(a: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and C-order bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def results() -> dict[str, np.ndarray]:
    """Every decode and resize of the set, by name."""
    rng = np.random.default_rng(SEED)
    up = rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
    down = rng.integers(0, 256, (260, 300, 3), dtype=np.uint8)
    ids = rng.integers(0, 151, (80, 96), dtype=np.uint8)
    scene = resize.imread_rgb(str(FILES / "scene.jpg"))
    inst = resize.imread_unchanged(str(FILES / "instance_ids.png"))
    return {
        "jpeg_rgb": scene,
        "jpeg_linear": resize.resize_image(scene, SIZE),
        "png8_gray": resize.imread_gray(str(FILES / "labels.png")),
        "png16_unchanged": inst,
        "png16_nearest": resize.resize_mask(inst.astype(np.int32), SIZE),
        "seeded_linear_up": resize.resize_image(up, SIZE),
        "seeded_linear_down": resize.resize_image(down, SIZE),
        "seeded_nearest": resize.resize_mask(ids, SIZE),
    }


def digests() -> dict[str, str]:
    return {name: digest(a) for name, a in results().items()}


def host_libraries() -> dict:
    """The cv2 version, and whether matplotlib imports (the panels of
    `utils/visualize.py` need it)."""
    import cv2
    try:
        import matplotlib
        mpl = matplotlib.__version__
    except ImportError:
        mpl = None
    return {"cv2": cv2.__version__, "matplotlib": mpl}
