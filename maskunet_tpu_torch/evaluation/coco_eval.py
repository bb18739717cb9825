"""COCO-style detection/segmentation AP evaluator (COCOeval replacement).

This package's own copy of maskunet_tpu/evaluation/coco_eval.py, an
independent implementation of the COCOeval algorithm the reference calls
for instance and panoptic AP (ade_instance.py:441-447,
ade_panoptic.py:575-582, coco_instance.py:345-367): per-(image, category)
greedy matching of score-sorted detections to ground truths at each IoU
threshold (crowd gts match leniently and don't consume), 101-point
interpolated precision-recall accumulation, and the standard summarize()
statistics.

Faithful to pycocotools semantics used by the reference:
- segm IoU from RLE masks, iscrowd -> union = det area;
- unmatched detections falling in an ignored/crowd gt's score range are
  NOT counted as FPs when matched to ignored gts;
- configurable iouThrs (the reference sweeps linspace(0.5,0.95,10) and the
  COCO-panoptic script's linspace(0.30,0.95,10));
- maxDets capping, areaRng filtering.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from maskunet_tpu_torch.evaluation import rle as rle_lib


@dataclasses.dataclass
class EvalParams:
    iou_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.5, 0.95, 10))
    rec_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.0, 1.0, 101))
    max_dets: tuple[int, ...] = (1, 10, 100)
    area_rng: tuple[tuple[float, float], ...] = (
        (0.0, 1e10), (0.0, 32 ** 2), (32 ** 2, 96 ** 2), (96 ** 2, 1e10))
    area_rng_labels: tuple[str, ...] = ("all", "small", "medium", "large")


class COCOEvaluator:
    """gts/dts: lists of dicts with image_id, category_id, segmentation
    (RLE dict), area, score (dts), iscrowd (gts, optional)."""

    def __init__(self, gts: list[dict], dts: list[dict],
                 params: EvalParams | None = None):
        self.p = params or EvalParams()
        self.gts: dict[tuple, list] = {}
        self.dts: dict[tuple, list] = {}
        img_ids, cat_ids = set(), set()
        for g in gts:
            key = (g["image_id"], g["category_id"])
            self.gts.setdefault(key, []).append(g)
            img_ids.add(g["image_id"])
            cat_ids.add(g["category_id"])
        for d in dts:
            key = (d["image_id"], d["category_id"])
            self.dts.setdefault(key, []).append(d)
            img_ids.add(d["image_id"])
            cat_ids.add(d["category_id"])
        self.img_ids = sorted(img_ids)
        self.cat_ids = sorted(cat_ids)
        self._eval_imgs: dict = {}
        self.eval: dict = {}

    # ------------------------------------------------------------------
    def evaluate(self, num_threads: int | None = None) -> None:
        """Match detections per (image, category) pair.

        Scales to real COCO: only the (img, cat) pairs that actually
        carry gts or dts are visited (the dense cats x imgs x areas loop
        is 133 x 10k x 4 = 5.3M mostly-empty calls at COCO size), the
        mask IoU matrix is computed ONCE per pair and shared by all four
        area ranges, and pairs are fanned out over threads (the native
        RLE IoU kernel releases the GIL). `num_threads=None` picks
        min(8, cpu count); pass 1 to force serial.
        """
        import concurrent.futures
        import os as _os

        max_det = max(self.p.max_dets)
        keys = sorted(set(self.gts) | set(self.dts))
        if num_threads is None:
            num_threads = min(8, _os.cpu_count() or 1)

        def work(key):
            img, cat = key
            return key, self._evaluate_pair(img, cat, max_det)

        if num_threads > 1 and len(keys) > 64:
            with concurrent.futures.ThreadPoolExecutor(num_threads) as ex:
                results = list(ex.map(work, keys, chunksize=64))
        else:
            results = [work(k) for k in keys]
        self._by_cat_area = {}
        # `keys` is sorted by (img, cat), so each (cat, a_idx) entry list
        # is in ascending-image-id order — identical to iterating
        # self.img_ids (itself sorted) as accumulate()'s dense fallback
        # and pycocotools (with ascending imgIds) do, so tied-score
        # mergesort tie-breaks match the reference tooling exactly.
        for (img, cat), per_area in results:
            for a_idx, entry in enumerate(per_area):
                self._eval_imgs[(img, cat, a_idx)] = entry
                if entry is not None:
                    self._by_cat_area.setdefault((cat, a_idx),
                                                 []).append(entry)

    def _evaluate_pair(self, img, cat, max_det) -> list:
        """All area-range entries for one (image, category): sort, IoU
        and per-object areas computed once, matching per range."""
        gts = self.gts.get((img, cat), [])
        dts = self.dts.get((img, cat), [])
        if not gts and not dts:
            return [None] * len(self.p.area_rng)
        dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
        iscrowd_raw = [bool(g.get("iscrowd", 0)) for g in gts]
        if gts and dts:
            ious_raw = rle_lib.iou([d["segmentation"] for d in dts],
                                   [g["segmentation"] for g in gts],
                                   iscrowd_raw)
        else:
            ious_raw = np.zeros((len(dts), len(gts)))
        # key-presence semantics (pycocotools): a stored area of 0 is
        # used as-is, never recomputed
        g_areas = [g["area"] if "area" in g
                   else rle_lib.area(g["segmentation"]) for g in gts]
        d_areas = [d["area"] if "area" in d
                   else rle_lib.area(d["segmentation"]) for d in dts]
        return [self._match_range(gts, dts, ious_raw, iscrowd_raw,
                                  g_areas, d_areas, a_rng)
                for a_rng in self.p.area_rng]

    def _match_range(self, gts, dts, ious_raw, iscrowd_raw, g_areas,
                     d_areas, a_rng):
        gt_ignore = np.array([
            crowd or not (a_rng[0] <= area <= a_rng[1])
            for crowd, area in zip(iscrowd_raw, g_areas)], dtype=bool)
        # ignore-last gt order (pycocotools gtind sort)
        order_g = np.argsort(gt_ignore, kind="stable")
        gt_ignore = gt_ignore[order_g]
        iscrowd = [iscrowd_raw[i] for i in order_g]
        ious = ious_raw[:, order_g] if len(gts) and len(dts) else ious_raw

        t_count = len(self.p.iou_thrs)
        dt_match = np.zeros((t_count, len(dts)), dtype=np.int64)
        gt_match = np.zeros((t_count, len(gts)), dtype=np.int64)
        dt_ignore = np.zeros((t_count, len(dts)), dtype=bool)
        for t_idx, thr in enumerate(self.p.iou_thrs):
            for d_idx, d in enumerate(dts):
                iou = min(thr, 1 - 1e-10)
                m = -1
                for g_idx in range(len(gts)):
                    if gt_match[t_idx, g_idx] > 0 and not iscrowd[g_idx]:
                        continue
                    if (m > -1 and not gt_ignore[m] and gt_ignore[g_idx]):
                        break   # gts sorted ignore-last; stop at ignores
                    if ious[d_idx, g_idx] < iou:
                        continue
                    iou = ious[d_idx, g_idx]
                    m = g_idx
                if m == -1:
                    continue
                dt_match[t_idx, d_idx] = 1
                gt_match[t_idx, m] = 1
                dt_ignore[t_idx, d_idx] = gt_ignore[m]
        # unmatched dts outside the area range are ignored too
        dt_out_of_rng = np.array([
            not (a_rng[0] <= area <= a_rng[1])
            for area in d_areas], dtype=bool) if dts else np.zeros(0, bool)
        dt_ignore |= (dt_match == 0) & dt_out_of_rng[None, :]
        return {
            "scores": np.array([d["score"] for d in dts]),
            "dt_match": dt_match,
            "dt_ignore": dt_ignore,
            "num_gt": int(np.count_nonzero(~gt_ignore)),
        }

    # ------------------------------------------------------------------
    def accumulate(self) -> None:
        p = self.p
        t_n, r_n = len(p.iou_thrs), len(p.rec_thrs)
        k_n, a_n, m_n = len(self.cat_ids), len(p.area_rng), len(p.max_dets)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))
        by_cat_area = getattr(self, "_by_cat_area", None)
        for k_idx, cat in enumerate(self.cat_ids):
            for a_idx in range(a_n):
                if by_cat_area is not None:
                    entries = by_cat_area.get((cat, a_idx), [])
                else:   # evaluate() not called through the sparse path
                    entries = [self._eval_imgs.get((img, cat, a_idx))
                               for img in self.img_ids]
                    entries = [e for e in entries if e is not None]
                if not entries:
                    continue
                for m_idx, max_det in enumerate(p.max_dets):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in entries])
                    order = np.argsort(-scores, kind="mergesort")
                    matches = np.concatenate(
                        [e["dt_match"][:, :max_det] for e in entries],
                        axis=1)[:, order]
                    ignores = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in entries],
                        axis=1)[:, order]
                    num_gt = sum(e["num_gt"] for e in entries)
                    if num_gt == 0:
                        continue
                    tps = np.logical_and(matches, ~ignores)
                    fps = np.logical_and(~matches.astype(bool), ~ignores)
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t_idx in range(t_n):
                        tp, fp = tp_sum[t_idx], fp_sum[t_idx]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t_idx, k_idx, a_idx, m_idx] = (
                            rc[-1] if len(rc) else 0.0)
                        # monotone precision envelope
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, p.rec_thrs, side="left")
                        q = np.zeros(r_n)
                        for r_idx, pi in enumerate(inds):
                            if pi < len(pr):
                                q[r_idx] = pr[pi]
                        precision[t_idx, :, k_idx, a_idx, m_idx] = q
        self.eval = {"precision": precision, "recall": recall}

    # ------------------------------------------------------------------
    def _summarize(self, ap: bool = True, iou_thr: float | None = None,
                   area: str = "all", max_dets: int = 100) -> float:
        p = self.p
        a_idx = p.area_rng_labels.index(area)
        m_idx = p.max_dets.index(max_dets)
        if ap:
            s = self.eval["precision"][:, :, :, a_idx, m_idx]
        else:
            s = self.eval["recall"][:, :, a_idx, m_idx]
        if iou_thr is not None:
            t_idx = int(np.argmin(np.abs(p.iou_thrs - iou_thr)))
            s = s[t_idx:t_idx + 1]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def summarize(self) -> dict[str, float]:
        md = max(self.p.max_dets)
        stats = {
            "AP": self._summarize(True, None, "all", md),
            "AP50": self._summarize(True, 0.5, "all", md),
            "AP75": self._summarize(True, 0.75, "all", md),
            "AP_small": self._summarize(True, None, "small", md),
            "AP_medium": self._summarize(True, None, "medium", md),
            "AP_large": self._summarize(True, None, "large", md),
            "AR": self._summarize(False, None, "all", md),
        }
        return stats


def evaluate_ap(gts: list[dict], dts: list[dict],
                iou_thrs: np.ndarray | None = None,
                max_dets: tuple[int, ...] = (1, 10, 100)) -> dict[str, float]:
    """One-call evaluate/accumulate/summarize (the reference's usage)."""
    params = EvalParams(max_dets=max_dets)
    if iou_thrs is not None:
        params.iou_thrs = np.asarray(iou_thrs)
    ev = COCOEvaluator(gts, dts, params)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize()
