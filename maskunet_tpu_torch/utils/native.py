"""ctypes bindings for the native mask-ops library (csrc/maskops.cpp).

Counterpart of maskunet_tpu/utils/native.py. The library is built with
g++ at first use into `maskunet_tpu_torch/_build/` (named by a digest of
the source and flags, written under a temporary name and renamed, so
processes that build at once do not collide). No `-march=native`: the
built library may be copied between hosts. A failed build raises; there
is no fallback (the JAX package falls back to cv2 and numpy).

- `available()`: the library loads (building it at first use).
- `cc_label(mask) -> (num_labels, labels)`: 8-connectivity connected
  components (cv2.connectedComponents-compatible).
- `mask_iou(dt_masks, gt_masks, iscrowd) -> [nd, ng] IoU matrix`
  (bit-packed popcount intersections; COCOeval crowd semantics).

ctypes releases the interpreter lock during each call, so evaluation
threads overlap in these.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "maskops.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL] = []


def build() -> Path:
    """The built library's path, compiling it first if needed."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmaskops_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _lib() -> ctypes.CDLL:
    """The loaded library; the first caller builds it, other threads wait
    (the evaluators call in from a pool)."""
    with _LOCK:
        if not _LIB:
            lib = ctypes.CDLL(str(build()))
            lib.cc_label.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _i32p]
            lib.cc_label.restype = ctypes.c_int
            lib.mask_iou.argtypes = [_u8p, ctypes.c_int, _u8p, ctypes.c_int,
                                     ctypes.c_int, _u8p, _f64p]
            lib.mask_iou.restype = None
            _LIB.append(lib)
        return _LIB[0]


def available() -> bool:
    """Whether the library is loaded, building it first if needed (JAX's
    `available`; without a fallback here, a failed build raises)."""
    return _lib() is not None


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def cc_label(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """mask [H, W] (nonzero = foreground) -> (number of labels including
    the background 0, int32 labels [H, W])."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"cc_label takes a 2-d mask, got {mask.shape}")
    h, w = mask.shape
    out = np.zeros((h, w), np.int32)
    n = _lib().cc_label(_ptr(mask, _u8p), h, w, _ptr(out, _i32p))
    return int(n), out


def mask_iou(dt: np.ndarray, gt: np.ndarray,
             iscrowd: np.ndarray | None = None) -> np.ndarray:
    """dt: [nd, H, W], gt: [ng, H, W] binary masks; iscrowd [ng]. Returns
    the f64 IoU matrix [nd, ng] (crowd gt: the union is the detection's
    area)."""
    nd, h, w = dt.shape
    ng = gt.shape[0]
    if gt.shape[1:] != (h, w):
        raise ValueError(f"mask shapes differ: {dt.shape} vs {gt.shape}")
    dt = np.ascontiguousarray(dt.reshape(nd, h * w), np.uint8)
    gt = np.ascontiguousarray(gt.reshape(ng, h * w), np.uint8)
    crowd = np.ascontiguousarray(
        iscrowd if iscrowd is not None else np.zeros(ng), np.uint8)
    if crowd.shape != (ng,):
        raise ValueError(f"iscrowd needs {ng} entries, got {crowd.shape}")
    out = np.zeros((nd, ng), np.float64)
    _lib().mask_iou(_ptr(dt, _u8p), nd, _ptr(gt, _u8p), ng, h * w,
                    _ptr(crowd, _u8p), _ptr(out, _f64p))
    return out
