"""The port's evaluation modules against the JAX package's, exactly.

The same seeded numpy inputs go through `maskunet_tpu.evaluation` and
`maskunet_tpu_torch.evaluation`; every output must be equal, not close:
RLE strings and areas, connected-component labels, the mask IoU matrix
(the native kernel and its numpy version, crowds included), instance
lists, DBSCAN masks in order (the port's PyTorch DBSCAN against JAX's
scikit-learn, with and without `max_pixels_per_class`), `evaluate_ap`
stats at both of the reference's IoU sweeps, `pq_compute` stats, and the
panoptic export (the port's own PNG writer: chunks and CRCs parsed by
hand, the pixels decoded by PIL against the JAX package's cv2 files).
The native library's build raises when g++ fails: there is no fallback.
"""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from maskunet_tpu.evaluation import clustering as jclu
from maskunet_tpu.evaluation import coco_eval as jcoco
from maskunet_tpu.evaluation import instances as jinst
from maskunet_tpu.evaluation import panoptic as jpan
from maskunet_tpu.evaluation import rle as jrle
from maskunet_tpu.utils import native as jnative
from maskunet_tpu_torch.evaluation import clustering as tclu
from maskunet_tpu_torch.evaluation import coco_eval as tcoco
from maskunet_tpu_torch.evaluation import instances as tinst
from maskunet_tpu_torch.evaluation import panoptic as tpan
from maskunet_tpu_torch.evaluation import rle as trle
from maskunet_tpu_torch.utils import native as tnative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host, and torch's default of a thread per core in each
    oversubscribes it (a 16 px `train()` then runs ~10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rect_map(rng, h=32, w=40, n=6, classes=5, base=0):
    """A class map of `n` random rectangles over class `base`."""
    m = np.full((h, w), base, np.int64)
    for _ in range(n):
        y, x = rng.integers(0, h - 3), rng.integers(0, w - 3)
        m[y:y + rng.integers(3, h // 2), x:x + rng.integers(3, w // 2)] = \
            rng.integers(1, classes)
    return m


def _masks(rng, n=12, h=21, w=17):
    out = [rng.random((h, w)) < rng.uniform(0.05, 0.9) for _ in range(n)]
    return out + [np.zeros((h, w), bool), np.ones((h, w), bool)]


def test_rle_matches_jax(rng):
    masks = _masks(rng)
    for m in masks:
        got, want = trle.encode(m.astype(np.uint8)), jrle.encode(m)
        assert got == want
        assert trle.area(got) == jrle.area(want) == int(m.sum())
        assert np.array_equal(trle.decode(got), m)
        counts = trle._decompress(got["counts"])
        assert counts == jrle._decompress(want["counts"])
        assert trle._compress(counts) == got["counts"]
    rles = [trle.encode(m.astype(np.uint8)) for m in masks[:5]]
    assert trle.merge(rles) == jrle.merge(rles)
    poly = [[0, 0, 5, 0, 5, 5], [1.4, 6.6, 7.5, 6, 7, 7.6, 2, 7.2],
            [1, 1, 2, 2]]
    assert np.array_equal(trle.segmentation_to_mask(poly, 8, 8),
                          jrle.segmentation_to_mask(poly, 8, 8))


def test_cc_label_matches_jax(rng):
    for density in (0.2, 0.45, 0.6):
        m = (rng.random((33, 47)) < density).astype(np.uint8)
        n, labels = tnative.cc_label(m)
        jn, jlabels = jnative.cc_label(m)
        assert n == jn and np.array_equal(labels, jlabels)


def test_mask_iou_native_and_plain_match_jax(rng):
    dts = [trle.encode(m.astype(np.uint8)) for m in _masks(rng, 9)]
    gts = [trle.encode(m.astype(np.uint8)) for m in _masks(rng, 7)]
    crowd = [bool(c) for c in rng.random(len(gts)) < 0.4]
    want = jrle.iou(dts, gts, crowd)
    assert np.array_equal(trle.iou(dts, gts, crowd), want)
    assert np.array_equal(trle.iou_plain(dts, gts, crowd), want)
    assert trle.iou([], gts).shape == (0, len(gts))


def test_instance_lists_match_jax(rng):
    pred = _rect_map(rng, classes=6)
    prob = rng.random(pred.shape + (6,)).astype(np.float32)
    assert tinst.get_instances_from_mask(pred, prob) == \
        jinst.get_instances_from_mask(pred, prob)
    assert tinst.get_instances_from_mask(pred) == \
        jinst.get_instances_from_mask(pred)
    inst = _rect_map(rng, n=8, classes=9)
    sem = _rect_map(rng, classes=5)
    sem[:2] = 255
    assert tinst.instances_from_id_map(inst, sem) == \
        jinst.instances_from_id_map(inst, sem)
    dts = tinst.get_instances_from_mask(pred, prob)
    assert tinst.top_k_by_score(dts, 3) == jinst.top_k_by_score(dts, 3)


def _embedding_scene(rng, h=24, w=24, d=16):
    """Classes of rectangles; each class's pixels in 2-3 embedding clumps
    (tight enough for DBSCAN at eps 0.5, with strays as noise)."""
    sem = _rect_map(rng, h, w, n=7, classes=4)
    emb = rng.standard_normal((h, w, d)).astype(np.float32) * 2.0
    for cls in range(1, 4):
        ys, xs = np.nonzero(sem == cls)
        centers = rng.standard_normal((3, d)) * 2.0
        which = rng.integers(0, 3, len(ys))
        spread = rng.choice([0.02, 0.06, 0.12], len(ys))[:, None]
        emb[ys, xs] = centers[which] + rng.standard_normal(
            (len(ys), d)) * spread
    return sem, emb


@pytest.mark.parametrize("max_pixels", [None, 60])
def test_dbscan_instances_match_jax_sklearn(rng, max_pixels):
    for _ in range(3):
        sem, emb = _embedding_scene(rng)
        want = jclu.instances_from_embeddings(
            sem, emb, max_pixels_per_class=max_pixels)
        got = tclu.instances_from_embeddings(
            sem, torch.from_numpy(emb), max_pixels_per_class=max_pixels)
        assert len(got) == len(want) > 1
        assert all(np.array_equal(g, m) for g, m in zip(got, want))
        assert tclu.annotate_instances(got, sem) == \
            jclu.annotate_instances(want, sem)


def test_dbscan_labels_match_sklearn_on_points(rng):
    from sklearn.cluster import DBSCAN
    for d, scale in ((2, 0.4), (16, 0.15), (16, 0.3)):
        x = rng.standard_normal((300, d)).astype(np.float32) * scale
        x[:100] += 3.0                      # a second blob
        want = DBSCAN(eps=0.5, min_samples=5).fit_predict(x)
        assert np.array_equal(tclu.dbscan(torch.from_numpy(x)).numpy(),
                              want)


def _annotations(rng, n_images=12, n_cats=4, h=32, w=32):
    gts, dts = [], []
    for img in range(n_images):
        for _ in range(rng.integers(1, 5)):
            cat = int(rng.integers(1, n_cats + 1))
            m = _rect_map(rng, h, w, n=1, classes=2) > 0
            crowd = bool(rng.random() < 0.15)
            gts.append({"image_id": img, "category_id": cat,
                        "segmentation": jrle.encode(m), "area": int(m.sum()),
                        "iscrowd": int(crowd)})
            for _ in range(rng.integers(0, 3)):   # shifted detections
                dm = np.roll(m, rng.integers(-3, 4, 2), axis=(0, 1))
                dts.append({"image_id": img, "category_id": cat,
                            "segmentation": jrle.encode(dm),
                            "area": int(dm.sum()),
                            "score": round(float(rng.random()), 1)})
        for _ in range(rng.integers(0, 3)):       # false positives
            m = _rect_map(rng, h, w, n=1, classes=2) > 0
            dts.append({"image_id": img,
                        "category_id": int(rng.integers(1, n_cats + 1)),
                        "segmentation": jrle.encode(m), "area": int(m.sum()),
                        "score": round(float(rng.random()), 1)})
    return gts, dts


@pytest.mark.parametrize("iou_thrs", [None, np.linspace(0.30, 0.95, 10)])
def test_evaluate_ap_matches_jax(rng, iou_thrs):
    gts, dts = _annotations(rng, n_images=40)   # > 64 pairs: threads
    want = jcoco.evaluate_ap(gts, dts, iou_thrs=iou_thrs)
    got = tcoco.evaluate_ap(gts, dts, iou_thrs=iou_thrs)
    assert got == want
    assert 0 < got["AP"] < 1


def test_pq_compute_matches_jax(rng):
    images = []
    things = {1, 2, 3}
    for _ in range(10):
        label = _rect_map(rng, n=6, classes=6)
        label[:, :2] = 0                        # void
        inst = _rect_map(rng, n=9, classes=12)
        gt_pan, gt_segs = jpan.semantic_to_panoptic(label, inst, things)
        if gt_segs and rng.random() < 0.5:
            gt_segs[0]["iscrowd"] = 1
        pred = label.copy()
        pred[rng.random(pred.shape) < 0.1] = 4
        pred_pan, pred_segs = tpan.semantic_to_panoptic(pred, None, things)
        want = jpan.semantic_to_panoptic(pred, None, things)
        assert np.array_equal(pred_pan, want[0]) and pred_segs == want[1]
        images.append((gt_pan, gt_segs, pred_pan, pred_segs))
    got = tpan.pq_compute(images, things=things)
    assert got == jpan.pq_compute(images, things=things)
    assert got["All"]["n"] > 0
    assert tpan.pq_compute(images * 7, things=things) == \
        jpan.pq_compute(images * 7, things=things)        # threaded


def _png_chunks(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.append((kind, body))
        pos += 12 + n
    return chunks


def test_png_writer_round_trip(tmp_path, rng):
    rgb = rng.integers(0, 256, (13, 29, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    tpan.write_png_rgb(path, rgb)
    with open(path, "rb") as f:
        chunks = _png_chunks(f.read())
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", chunks[0][1]) == (29, 13, 8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = rows.reshape(13, 1 + 29 * 3)
    assert not rows[:, 0].any()                 # filter 0 on every row
    assert np.array_equal(rows[:, 1:].reshape(13, 29, 3), rgb)


def test_panoptic_export_matches_jax(tmp_path, rng):
    pytest.importorskip("cv2")                  # the JAX package's writer
    from PIL import Image
    preds = []
    for image_id in (3, 17):
        sem = _rect_map(rng, n=8, classes=7)
        pan, segs = tpan.semantic_to_panoptic(sem, None, None)
        preds.append((image_id, pan * 300, [{**s, "id": s["id"] * 300}
                                            for s in segs]))
    got = tpan.save_panoptic_predictions(preds, str(tmp_path / "port"))
    want = jpan.save_panoptic_predictions(preds, str(tmp_path / "jax"))
    with open(got) as f, open(want) as g:
        assert json.load(f) == json.load(g)
    for image_id, pan, _ in preds:
        name = f"{image_id:012d}.png"
        a = np.asarray(Image.open(tmp_path / "port" / name))
        b = np.asarray(Image.open(tmp_path / "jax" / name))
        assert np.array_equal(a, b)
        assert np.array_equal(a, tpan.id2rgb(pan))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a source g++ cannot compile raises, naming it."""
    bad = tmp_path / "maskops.cpp"
    bad.write_text("int cc_label(;\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()
    assert not list((tmp_path / "_build").glob("*.so"))
