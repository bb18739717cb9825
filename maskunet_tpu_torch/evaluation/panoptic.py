"""Panoptic Quality (PQ) computation — panopticapi pq_compute replacement.

This package's own copy of maskunet_tpu/evaluation/panoptic.py. The
reference feeds *instance-format* JSONs into panopticapi's pq_compute
(a format mismatch noted as a reference bug, SURVEY.md §2.4
ade_panoptic.py:583-584); here PQ is computed correctly from panoptic
id-maps + segments_info, per the PQ definition (Kirillov et al.):

    PQ = sum_{TP} IoU / (|TP| + |FP|/2 + |FN|/2),  SQ = IoU/|TP|, RQ = F1

- a prediction matches a gt segment iff same category and IoU > 0.5
  (matches are unique by construction since IoU > 0.5);
- pixels with the VOID label are excluded from the union;
- gt segments flagged iscrowd are excluded from matching but absorb
  predictions (not counted FP) when majority-covered, per panopticapi.
- results split All / Things / Stuff via the category `isthing` flag.

The export writes its PNGs with a small RGB8 writer of its own (`zlib`
and the chunk CRCs; the JAX package calls cv2.imwrite).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from collections import defaultdict

import numpy as np

VOID = 0


@dataclasses.dataclass
class PQStatCat:
    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0


def pq_compute_single_image(
        gt_map: np.ndarray, gt_segments: list[dict],
        pred_map: np.ndarray, pred_segments: list[dict],
        stats: dict[int, PQStatCat], *, void: int = VOID) -> None:
    """Accumulate one image into per-category PQ stats.

    Maps hold segment ids; segments_info dicts hold {id, category_id,
    iscrowd?}. Pixels with map value `void` are unlabeled.
    """
    gt_info = {s["id"]: s for s in gt_segments}
    pred_info = {s["id"]: s for s in pred_segments}

    # joint histogram of (gt_id, pred_id) pixel pairs
    combined = gt_map.astype(np.uint64) * (2 ** 32) + pred_map.astype(
        np.uint64)
    ids, counts = np.unique(combined, return_counts=True)
    inter: dict[tuple[int, int], int] = {}
    gt_areas: dict[int, int] = defaultdict(int)
    pred_areas: dict[int, int] = defaultdict(int)
    for pair, cnt in zip(ids.tolist(), counts.tolist()):
        g, p = pair >> 32, pair & 0xFFFFFFFF
        inter[(g, p)] = cnt
        gt_areas[g] += cnt
        pred_areas[p] += cnt

    matched_gt, matched_pred = set(), set()
    for (g, p), cnt in inter.items():
        if g == void or p == void:
            continue
        if g not in gt_info or p not in pred_info:
            continue
        if gt_info[g].get("iscrowd", 0):
            continue
        if gt_info[g]["category_id"] != pred_info[p]["category_id"]:
            continue
        # panopticapi convention: pred pixels lying on gt-VOID are
        # excluded from the union (gt left them unlabeled); gt pixels on
        # pred-void still count against the prediction.
        union = (gt_areas[g] + pred_areas[p] - cnt
                 - inter.get((void, p), 0))
        iou = cnt / union if union > 0 else 0.0
        if iou > 0.5:
            cat = gt_info[g]["category_id"]
            stats.setdefault(cat, PQStatCat())
            stats[cat].tp += 1
            stats[cat].iou += iou
            matched_gt.add(g)
            matched_pred.add(p)

    crowd_by_cat: dict[int, int] = {}
    for g, info in gt_info.items():
        if info.get("iscrowd", 0):
            crowd_by_cat[info["category_id"]] = g
            continue
        if g not in matched_gt:
            cat = info["category_id"]
            stats.setdefault(cat, PQStatCat())
            stats[cat].fn += 1
    for p, info in pred_info.items():
        if p in matched_pred:
            continue
        area = pred_areas.get(p, 0)
        if area == 0:
            continue
        # majority void or crowd-of-same-category absorption -> not FP
        void_overlap = inter.get((void, p), 0)
        crowd_overlap = 0
        crowd_id = crowd_by_cat.get(info["category_id"])
        if crowd_id is not None:
            crowd_overlap = inter.get((crowd_id, p), 0)
        if (void_overlap + crowd_overlap) / area > 0.5:
            continue
        cat = info["category_id"]
        stats.setdefault(cat, PQStatCat())
        stats[cat].fp += 1


def pq_summarize(stats: dict[int, PQStatCat],
                 things: set[int] | None = None) -> dict[str, dict]:
    """Per-split {pq, sq, rq, n} for All / Things / Stuff (panopticapi
    console format, printed by the reference at ade_panoptic.py:588-592)."""

    def agg(cats):
        pq = sq = rq = 0.0
        n = 0
        for c in cats:
            s = stats[c]
            if s.tp + s.fp + s.fn == 0:
                continue
            n += 1
            pq_c = s.iou / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
            sq_c = s.iou / s.tp if s.tp else 0.0
            rq_c = s.tp / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
            pq += pq_c
            sq += sq_c
            rq += rq_c
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}

    all_cats = list(stats)
    result = {"All": agg(all_cats)}
    if things is not None:
        result["Things"] = agg([c for c in all_cats if c in things])
        result["Stuff"] = agg([c for c in all_cats if c not in things])
    return result


def pq_compute(images: list[tuple[np.ndarray, list[dict],
                                  np.ndarray, list[dict]]],
               things: set[int] | None = None,
               void: int = VOID,
               num_threads: int | None = None) -> dict[str, dict]:
    """Full pq_compute over (gt_map, gt_segments, pred_map, pred_segments)
    tuples. Images are independent, so large runs fan out over threads
    (the np.unique histogram releases the GIL); per-thread stats merge
    additively. `num_threads=None` threads only beyond 64 images."""
    import concurrent.futures
    import os as _os

    def run_chunk(chunk) -> dict[int, PQStatCat]:
        local: dict[int, PQStatCat] = {}
        for gt_map, gt_segs, pred_map, pred_segs in chunk:
            pq_compute_single_image(gt_map, gt_segs, pred_map, pred_segs,
                                    local, void=void)
        return local

    n = num_threads if num_threads is not None else (
        min(8, _os.cpu_count() or 1) if len(images) > 64 else 1)
    if n <= 1:
        stats = run_chunk(images)
    else:
        chunks = [images[i::n] for i in range(n)]
        stats = {}
        with concurrent.futures.ThreadPoolExecutor(n) as ex:
            for local in ex.map(run_chunk, chunks):
                for cat, s in local.items():
                    agg = stats.setdefault(cat, PQStatCat())
                    agg.iou += s.iou
                    agg.tp += s.tp
                    agg.fp += s.fp
                    agg.fn += s.fn
    return pq_summarize(stats, things)


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """panopticapi's id -> RGB coding (id = R + 256 G + 256^2 B)."""
    out = np.zeros(id_map.shape + (3,), dtype=np.uint8)
    out[..., 0] = id_map % 256
    out[..., 1] = (id_map // 256) % 256
    out[..., 2] = (id_map // (256 * 256)) % 256
    return out


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG (no interlace,
    filter type 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png_rgb takes [H, W, 3], got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _png_chunk(b"IEND", b""))


def save_panoptic_predictions(predictions: list[tuple[int, np.ndarray,
                                                      list[dict]]],
                              out_dir: str,
                              json_name: str = "predictions.json") -> str:
    """Write panoptic predictions to disk in the panopticapi layout
    (per-image id2rgb PNG + a predictions json) — the export path of the
    reference's `save_predictions` (coco_panoptic.py:388-425), with real
    segments_info instead of its empty lists.

    predictions: (image_id, panoptic_id_map, segments_info) tuples.
    Returns the json path.
    """
    import json
    import os

    os.makedirs(out_dir, exist_ok=True)
    annotations = []
    for image_id, pan_map, segments in predictions:
        file_name = f"{image_id:012d}.png"
        write_png_rgb(os.path.join(out_dir, file_name),
                      id2rgb(pan_map.astype(np.int64)))
        annotations.append({
            "image_id": int(image_id),
            "file_name": file_name,
            "segments_info": [
                {"id": int(s["id"]), "category_id": int(s["category_id"])}
                for s in segments],
        })
    json_path = os.path.join(out_dir, json_name)
    with open(json_path, "w") as f:
        json.dump({"annotations": annotations}, f)
    return json_path


def semantic_to_panoptic(sem_map: np.ndarray,
                         inst_map: np.ndarray | None = None,
                         things: set[int] | None = None
                         ) -> tuple[np.ndarray, list[dict]]:
    """Build a panoptic id-map + segments_info from an argmax semantic map
    (stuff: one segment per class; things: connected components or the
    given instance map) — the fusion step the reference approximates with
    connected components (ade_panoptic.py:540-541)."""
    from maskunet_tpu_torch.evaluation.instances import connected_components

    pan = np.zeros_like(sem_map, dtype=np.int64)
    segments: list[dict] = []
    next_id = 1
    for cls in np.unique(sem_map):
        if cls == 0 or cls == 255:
            continue
        cls_mask = sem_map == cls
        if things is not None and int(cls) not in things:
            pan[cls_mask] = next_id
            segments.append({"id": next_id, "category_id": int(cls)})
            next_id += 1
            continue
        if inst_map is not None:
            for iid in np.unique(inst_map[cls_mask]):
                m = cls_mask & (inst_map == iid)
                if not m.any():
                    continue
                pan[m] = next_id
                segments.append({"id": next_id, "category_id": int(cls)})
                next_id += 1
        else:
            num, comps = connected_components(cls_mask)
            for comp in range(1, num):
                m = comps == comp
                pan[m] = next_id
                segments.append({"id": next_id, "category_id": int(cls)})
                next_id += 1
    return pan, segments
