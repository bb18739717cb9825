"""Host-side image I/O and resizing with the reference's cv2 semantics.

This package's own copy of maskunet_tpu/data/resize.py. The port decodes
PNG and JPEG with OpenCV (`cv2`), imported inside each function so that
importing the port never loads it. Label parity needs exactly the
reference's resize: cv2 INTER_LINEAR (half-pixel centres) for images,
INTER_NEAREST for id masks (ade_semantic.py:72-73). These wrappers pin the
conventions in one place: BGR->RGB, (w, h) size order, IMREAD_UNCHANGED
for Cityscapes' 16-bit instance ids.

Decoding and resizing a fixed set of files (`data/image_check.py`) gives
the same bytes under cv2 5.0.0 on an x86 CPU host and cv2 4.13.0 on the
H100's host: `tests/test_torch_datasets.py` pins the digests for the
first and `chip_smoke.py`'s `image_io` phase checks them on the second.
"""

from __future__ import annotations

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"Could not read {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"Could not read {path}")
    return img


def imread_unchanged(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"Could not read {path}")
    return img


def resize_image(img: np.ndarray, size: int | tuple[int, int]) -> np.ndarray:
    import cv2

    w, h = (size, size) if isinstance(size, int) else size
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def resize_mask(mask: np.ndarray, size: int | tuple[int, int]) -> np.ndarray:
    import cv2

    w, h = (size, size) if isinstance(size, int) else size
    return cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST)
