"""COCO run-length-encoding codec and mask ops (pycocotools replacement).

This package's own copy of maskunet_tpu/evaluation/rle.py. pycocotools is
a C extension the reference depends on for RLE encode/decode and mask IoU;
this module implements the same wire formats from the spec:

- *uncompressed RLE*: `{"size": [h, w], "counts": [int, ...]}` — run
  lengths over the mask flattened in **column-major** (Fortran) order,
  starting with the count of zeros;
- *compressed RLE*: `{"size": [h, w], "counts": str}` — the LEB128-style
  base-32 ASCII coding used by COCO (5 bits per char, offset 48,
  continuation bit 0x20, counts delta-coded against counts[i-2] from the
  third element on).

Mask IoU follows COCOeval semantics including the `iscrowd` variant (union
= area of the detection), through the native popcount kernel
(csrc/maskops.cpp); `iou_plain` is its numpy version, which tests hold it
against. Polygons are rasterised with cv2.fillPoly, as in the JAX
package; cv2 is imported inside `polygons_to_mask` only.
"""

from __future__ import annotations

import numpy as np


def encode(mask: np.ndarray) -> dict:
    """Binary mask [H, W] -> compressed RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).ravel(order="F").astype(bool)
    # run lengths, starting with zeros
    if flat.size == 0:
        counts: list[int] = []
    else:
        change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        boundaries = np.concatenate([[0], change, [flat.size]])
        counts = np.diff(boundaries).tolist()
        if flat[0]:   # first run must be zeros
            counts = [0] + counts
    return {"size": [h, w], "counts": _compress(counts)}


def decode(rle: dict) -> np.ndarray:
    """RLE dict (compressed or uncompressed counts) -> binary mask [H, W]."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decompress(counts)
    total = h * w
    flat = np.zeros(total, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decompress(counts)
    return int(sum(counts[1::2]))


def _compress(counts: list[int]) -> str:
    """COCO base-32 ASCII coding with delta against counts[i-2]."""
    out = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _decompress(s: str | bytes) -> list[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: list[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << k
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (k + 5)   # sign-extend
            k += 5
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def merge(rles: list[dict]) -> dict:
    """Union of several masks (pycocotools merge with intersect=False)."""
    if not rles:
        raise ValueError("merge of empty list")
    acc = decode(rles[0])
    for r in rles[1:]:
        acc |= decode(r)
    return encode(acc)


def iou(dt: list[dict], gt: list[dict],
        iscrowd: list[bool] | None = None) -> np.ndarray:
    """Pairwise IoU matrix [len(dt), len(gt)], COCOeval semantics: for a
    crowd gt, the union is the detection's area (gt treated as a region
    detections may freely overlap). Native bit-packed popcount kernel."""
    if iscrowd is None:
        iscrowd = [False] * len(gt)
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)), dtype=np.float64)

    from maskunet_tpu_torch.utils import native

    dt_dense = np.stack([decode(d) for d in dt])
    gt_dense = np.stack([decode(g) for g in gt])
    return native.mask_iou(dt_dense, gt_dense, np.asarray(iscrowd, np.uint8))


def iou_plain(dt: list[dict], gt: list[dict],
              iscrowd: list[bool] | None = None) -> np.ndarray:
    """`iou` in numpy (packed bits, one pair at a time)."""
    if iscrowd is None:
        iscrowd = [False] * len(gt)
    out = np.zeros((len(dt), len(gt)), dtype=np.float64)
    dt_masks = [np.packbits(decode(d).ravel(order="F")) for d in dt]
    gt_masks = [np.packbits(decode(g).ravel(order="F")) for g in gt]
    dt_areas = [area(d) for d in dt]
    gt_areas = [area(g) for g in gt]
    for j, (gm, ga, crowd) in enumerate(zip(gt_masks, gt_areas, iscrowd)):
        for i, (dm, da) in enumerate(zip(dt_masks, dt_areas)):
            inter = int(np.count_nonzero(np.unpackbits(dm & gm)))
            union = da if crowd else da + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def polygons_to_mask(polygons: list[list[float]], h: int, w: int
                     ) -> np.ndarray:
    """COCO polygon segmentation -> binary mask (cv2 rasterization).

    Replaces `COCO.annToMask` for polygon annotations
    (coco_instance.py:62-65). Boundary pixels may differ from pycocotools'
    integer-rounding rasterizer by a sub-pixel fringe, as in the JAX
    package.
    """
    import cv2

    mask = np.zeros((h, w), np.uint8)
    pts = [np.round(np.asarray(p).reshape(-1, 2)).astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygon list / RLE dict) -> binary mask."""
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        counts = seg.get("counts")
        if isinstance(counts, list):
            return decode({"size": seg["size"], "counts": counts})
        return decode(seg)
    raise TypeError(f"unsupported segmentation type: {type(seg)}")
