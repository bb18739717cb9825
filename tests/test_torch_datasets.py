"""The data slice: the port's image I/O, readers, fake layouts and the
evaluators on real layouts, against the JAX package.

- The layouts are written once per module by the JAX package's
  tools/make_fake_dataset.py (40 px scenes, 6 training and 4 validation
  images), plus hand-built edge layouts: 16-bit Cityscapes instance ids
  with and without `labelTrainIds`, multi-byte panoptic segment ids
  (`rgb2id`), and COCO polygon, crowd-RLE and compressed-RLE annotations.
- For all three datasets and every flavour, each example's arrays and the
  readers' num_classes, things_labels, cat2label and image ids are
  exactly equal to JAX's.
- The port's `make_fake_dataset` writes byte-identical files.
- `make_datasets` gives the nine recipes the same lengths and class
  counts as JAX's.
- `evaluate_instances` (coco_instance, ragged ground truth) and
  `evaluate_panoptic` (coco_panoptic) equal JAX's on the port's recorded
  `_iter_eval` batches, keyed by the real COCO image ids; no JAX model is
  compiled.
- The image I/O digests that `chip_smoke.py`'s `image_io` phase checks on
  the card's host are pinned here.
- One CPU `train()` at 16 px on a fake ADE layout; its first batch equals
  JAX's `BatchIterator` batch.
"""

import dataclasses
import filecmp
import importlib.util
import json
import math
import os

import cv2
import numpy as np
import pytest
import torch

from maskunet_tpu.data import ade20k as jade
from maskunet_tpu.data import cityscapes as jcity
from maskunet_tpu.data import coco as jcoco
from maskunet_tpu.data import pipeline as jpipeline
from maskunet_tpu.data import resize as jresize
from maskunet_tpu.evaluation import rle as jrle
from maskunet_tpu.tasks import datasets as jdatasets
from maskunet_tpu.tasks import evaluators as jev
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu_torch.data import ade20k as tade
from maskunet_tpu_torch.data import cityscapes as tcity
from maskunet_tpu_torch.data import coco as tcoco
from maskunet_tpu_torch.data import image_check
from maskunet_tpu_torch.data import pipeline as tpipeline
from maskunet_tpu_torch.data import resize as tresize
from maskunet_tpu_torch.evaluation import rle as trle
from maskunet_tpu_torch.tasks import datasets as tdatasets
from maskunet_tpu_torch.tasks import evaluators as tev
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.tools import make_fake_dataset as tfake
from maskunet_tpu_torch.train import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, N = 40, 6
IMG = 32            # the readers' output size in these tests


def _jax_fake_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_fake_dataset",
        os.path.join(REPO, "tools", "make_fake_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host (a 16 px `train()` runs ~10x slower oversubscribed)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """{kind: root} written by the JAX tool, and {kind: root} by the
    port's copy, at SIZE px with N training images."""
    jfake = _jax_fake_tool()
    base = tmp_path_factory.mktemp("layouts")
    roots = {}
    for owner, tool in (("jax", jfake), ("port", tfake)):
        for kind in ("ade", "coco", "cityscapes"):
            root = str(base / f"{owner}_{kind}")
            if kind == "cityscapes":
                tool.make_cityscapes(root, n=N, size=SIZE)
            else:
                getattr(tool, f"make_{kind}")(root, n=N, size=SIZE)
            roots[owner, kind] = root
    return roots


def _same_example(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _same_dataset(got, want) -> None:
    assert len(got) == len(want) > 0
    for attr in ("num_classes", "things_labels", "cat2label", "label2cat"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    for i in range(len(want)):
        assert got.image_id(i) == want.image_id(i)
        _same_example(got[i], want[i])


def test_image_io_digests_are_pinned():
    """The digests `chip_smoke.py` checks on the card's host (cv2 4.13)
    equal those of this host's cv2, and the port's I/O is JAX's."""
    assert image_check.digests() == image_check.EXPECTED
    for name in ("scene.jpg", "labels.png", "instance_ids.png"):
        path = str(image_check.FILES / name)
        for mode in ("imread_rgb", "imread_gray", "imread_unchanged"):
            a, b = getattr(tresize, mode)(path), getattr(jresize, mode)(path)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        img = tresize.imread_unchanged(path)
        for size in (17, (23, 31)):
            assert np.array_equal(tresize.resize_image(img, size),
                                  jresize.resize_image(img, size))
            assert np.array_equal(tresize.resize_mask(img, size),
                                  jresize.resize_mask(img, size))
    with pytest.raises(FileNotFoundError):
        tresize.imread_rgb(str(image_check.FILES / "missing.png"))


def test_fake_layouts_are_byte_identical(layouts):
    for kind in ("ade", "coco", "cityscapes"):
        a, b = layouts["port", kind], layouts["jax", kind]
        files = sorted(os.path.relpath(os.path.join(d, f), a)
                       for d, _, fs in os.walk(a) for f in fs)
        assert files and files == sorted(
            os.path.relpath(os.path.join(d, f), b)
            for d, _, fs in os.walk(b) for f in fs)
        _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
        assert not mismatch and not errors, (kind, mismatch, errors)


READERS = [
    ("ade", "semantic", lambda m, r, s: m.ADE20KSemanticDataset(r, s, IMG)),
    ("ade", "panoptic", lambda m, r, s: m.ADE20KPanopticDataset(r, s, IMG)),
    ("cityscapes", "semantic",
     lambda m, r, s: m.CityscapesDataset(r, s, IMG)),
    ("cityscapes", "instance",
     lambda m, r, s: m.CityscapesDataset(r, s, IMG, with_instance=True)),
    ("cityscapes", "panoptic",
     lambda m, r, s: m.CityscapesPanopticDataset(r, s, IMG)),
    ("coco", "semantic", lambda m, r, s: m.COCOSemanticDataset(
        *_coco_pan_paths(r, s), img_size=IMG)),
    ("coco", "panoptic", lambda m, r, s: m.COCOPanopticDataset(
        *_coco_pan_paths(r, s), img_size=IMG)),
    ("coco", "instance", lambda m, r, s: m.COCOInstanceDataset(
        *_coco_inst_paths(r, s), img_size=IMG)),
    ("coco", "instance_ragged", lambda m, r, s: m.COCOInstanceDataset(
        *_coco_inst_paths(r, s), img_size=IMG, summed_target=False)),
]
_MODULES = {"ade": (tade, jade), "cityscapes": (tcity, jcity),
            "coco": (tcoco, jcoco)}
_SPLITS = {"ade": ("training", "validation"), "cityscapes": ("train", "val"),
           "coco": ("train", "val")}


def _coco_pan_paths(root, split):
    sub = ("panoptic_train_subset", "train_subset") if split == "train" \
        else ("panoptic_val2017", "val2017")
    return (os.path.join(root, "annotations", f"{sub[0]}.json"),
            os.path.join(root, sub[0]), os.path.join(root, sub[1]))


def _coco_inst_paths(root, split):
    return (os.path.join(root, "annotations", f"instances_{split}2017.json"),
            os.path.join(root, "train_subset" if split == "train"
                         else "val2017"))


@pytest.mark.parametrize("kind, flavour, make",
                         READERS, ids=[f"{k}-{f}" for k, f, _ in READERS])
def test_reader_equals_jax_on_fake_layout(layouts, kind, flavour, make):
    tmod, jmod = _MODULES[kind]
    root = layouts["jax", kind]
    for split in _SPLITS[kind]:
        _same_dataset(make(tmod, root, split), make(jmod, root, split))


@pytest.fixture(scope="module")
def edge_roots(tmp_path_factory):
    """Hand-built layouts for the readers' edge cases."""
    root = tmp_path_factory.mktemp("edges")
    rng = np.random.default_rng(3)
    # Cityscapes: 16-bit instance ids (class 26 -> 255), one image with
    # labelTrainIds and one without (the `instanceIds // 1000` fallback),
    # and a city directory the panoptic glob must find
    for city, name, train_ids in (("cityA", "cityA_000", False),
                                  ("cityB", "cityB_001", True)):
        img_dir = root / "cs" / "leftImg8bit" / "train" / city
        gt_dir = root / "cs" / "gtFine" / "train" / city
        img_dir.mkdir(parents=True)
        gt_dir.mkdir(parents=True)
        h, w = 30, 40
        cv2.imwrite(str(img_dir / f"{name}_leftImg8bit.png"),
                    rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        labels = np.zeros((h, w), np.uint8)
        labels[:10], labels[10:20] = 5, 26
        cv2.imwrite(str(gt_dir / f"{name}_gtFine_labelIds.png"), labels)
        inst = np.zeros((h, w), np.uint16)
        inst[:10], inst[10:20], inst[20:, :7] = 5, 26005, 12003
        cv2.imwrite(str(gt_dir / f"{name}_gtFine_instanceIds.png"), inst)
        if train_ids:
            tid = np.full((h, w), 255, np.uint8)
            tid[:15] = 13
            cv2.imwrite(str(gt_dir / f"{name}_gtFine_labelTrainIds.png"),
                        tid)
    # COCO panoptic: segment ids past one byte
    coco = root / "coco"
    (coco / "imgs").mkdir(parents=True)
    (coco / "pan").mkdir()
    h, w = 30, 40
    cv2.imwrite(str(coco / "imgs" / "0001.jpg"),
                rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    seg = np.zeros((h, w), np.int32)
    seg[2:12, 2:18], seg[15:28, 20:38], seg[0:5, 30:40] = 7, 300, 70000
    cv2.imwrite(str(coco / "pan" / "0001.png"),
                cv2.cvtColor(jcoco.id2rgb(seg), cv2.COLOR_RGB2BGR))
    (coco / "panoptic.json").write_text(json.dumps({
        "images": [{"id": 42, "width": w, "height": h,
                    "file_name": "0001.jpg"}],
        "annotations": [{"image_id": 42, "file_name": "0001.png",
                         "segments_info": [
                             {"id": 7, "category_id": 20},
                             {"id": 300, "category_id": 10},
                             {"id": 70000, "category_id": 5}]}],
        "categories": [{"id": 10, "isthing": 0}, {"id": 20, "isthing": 1},
                       {"id": 5}]}))
    # COCO instances: polygons (one too short to count), an uncompressed
    # crowd RLE and a compressed RLE; an image without annotations
    crowd = np.zeros((h, w), np.uint8)
    crowd[20:29, 3:15] = 1
    counts = jrle._decompress(jrle.encode(crowd)["counts"])
    comp = np.zeros((h, w), np.uint8)
    comp[5:9, 25:39] = 1
    cv2.imwrite(str(coco / "imgs" / "0002.jpg"), np.zeros((h, w, 3),
                                                          np.uint8))
    (coco / "instances.json").write_text(json.dumps({
        "images": [{"id": 5, "width": w, "height": h,
                    "file_name": "0001.jpg"},
                   {"id": 9, "width": w, "height": h,
                    "file_name": "0002.jpg"}],
        "annotations": [
            {"id": 1, "image_id": 5, "category_id": 3, "iscrowd": 0,
             "segmentation": [[4, 4, 20, 4, 20, 20, 4, 20], [1, 1, 2, 2]]},
            {"id": 2, "image_id": 5, "category_id": 1, "iscrowd": 0,
             "segmentation": [[10.4, 10, 28, 10.6, 27.5, 28, 10, 28]]},
            {"id": 3, "image_id": 5, "category_id": 3, "iscrowd": 1,
             "segmentation": {"size": [h, w], "counts": counts}},
            {"id": 4, "image_id": 5, "category_id": 1, "iscrowd": 0,
             "segmentation": jrle.encode(comp)}],
        "categories": [{"id": 1}, {"id": 3}]}))
    return root


def test_readers_equal_jax_on_edge_layouts(edge_roots):
    cs = str(edge_roots / "cs")
    for make in (lambda m: m.CityscapesDataset(cs, "train", 32),
                 lambda m: m.CityscapesDataset(cs, "train", 32,
                                               with_instance=True),
                 lambda m: m.CityscapesPanopticDataset(cs, "train", 32)):
        got, want = make(tcity), make(jcity)
        _same_dataset(got, want)
    inst = got[0]["instance"]
    assert {26005, 12003} <= set(np.unique(inst))     # 16-bit ids survive
    assert 255 in got[0]["label"] and 13 in got[1]["label"]

    coco = str(edge_roots / "coco")
    for cls in ("COCOPanopticDataset", "COCOSemanticDataset"):
        args = (os.path.join(coco, "panoptic.json"),
                os.path.join(coco, "pan"), os.path.join(coco, "imgs"))
        got = getattr(tcoco, cls)(*args, img_size=32)
        _same_dataset(got, getattr(jcoco, cls)(*args, img_size=32))
    assert got.image_id(0) == 42 and got.things_labels == {0, 2}
    ids = np.array([[0, 7], [300, 70000]], np.int32)
    assert np.array_equal(tcoco.id2rgb(ids), jcoco.id2rgb(ids))
    assert np.array_equal(tcoco.rgb2id(tcoco.id2rgb(ids)), ids)
    for summed in (True, False):
        args = (os.path.join(coco, "instances.json"),
                os.path.join(coco, "imgs"))
        got = tcoco.COCOInstanceDataset(*args, img_size=32,
                                        summed_target=summed)
        _same_dataset(got, jcoco.COCOInstanceDataset(
            *args, img_size=32, summed_target=summed))
    assert got[0]["masks"].shape == (4, 32, 32) and got[1]["masks"].shape \
        == (0, 32, 32)


def test_polygons_and_segmentations_equal_jax():
    rng = np.random.default_rng(7)
    for _ in range(20):
        h, w = rng.integers(5, 40, 2)
        polys = [list(rng.uniform(-3, max(h, w) + 3, 2 * rng.integers(2, 7)))
                 for _ in range(rng.integers(0, 4))]
        got = trle.polygons_to_mask(polys, int(h), int(w))
        assert got.dtype == np.uint8
        assert np.array_equal(got, jrle.polygons_to_mask(polys, int(h),
                                                         int(w)))
        m = rng.random((h, w)) < 0.3
        for seg in (trle.encode(m.astype(np.uint8)),
                    {"size": [int(h), int(w)], "counts": trle._decompress(
                        trle.encode(m.astype(np.uint8))["counts"])},
                    polys):
            assert np.array_equal(trle.segmentation_to_mask(seg, h, w),
                                  jrle.segmentation_to_mask(seg, h, w))


def _roots(layouts) -> dict:
    return {"ade20k": layouts["jax", "ade"], "coco": layouts["jax", "coco"],
            "cityscapes": layouts["jax", "cityscapes"]}


@pytest.mark.parametrize("name", [
    "ade_semantic", "ade_instance", "ade_panoptic", "city_semantic",
    "city_instance", "city_panoptic", "coco_semantic", "coco_instance",
    "coco_panoptic"])
def test_make_datasets_equals_jax(layouts, name):
    recipe = dataclasses.replace(trecipes.get(name), img_size=16)
    jrecipe = dataclasses.replace(jrecipes.get(name), img_size=16)
    root = _roots(layouts)[recipe.dataset]
    ttrain, tval, tn = tdatasets.make_datasets(recipe, root)
    jtrain, jval, jn = jdatasets.make_datasets(jrecipe, root)
    assert (tn, len(ttrain), len(tval)) == (jn, len(jtrain), len(jval))
    assert type(ttrain).__name__ == type(jtrain).__name__
    _same_example(tval[0], jval[0])


def _recording(monkeypatch):
    records = []
    inner = tev._iter_eval

    def recording(*args, **kw):
        for item in inner(*args, **kw):
            records.append(item)
            yield item

    monkeypatch.setattr(tev, "_iter_eval", recording)
    return records


def _replay(monkeypatch, records, module):
    def replay(*args, **kw):
        for indices, ids, host in records:
            yield indices, ids, host

    monkeypatch.setattr(module, "_iter_eval", replay)


def _oracle(records):
    """The same batches with the labels as predictions."""
    return [(i, ids, {**h, "pred": h["label"].astype(np.int64)})
            for i, ids, h in records]


@pytest.mark.parametrize("name", ["coco_instance", "coco_panoptic"])
def test_coco_evaluators_equal_jax(monkeypatch, layouts, name):
    """The port's evaluator on its own eval step's batches (a fresh model
    at 16 px on the CPU), then both packages on the recorded batches and
    on oracle batches: equal results, records keyed by COCO's ids."""
    recipe = dataclasses.replace(trecipes.get(name), img_size=16,
                                 batch_size=3)
    jrecipe = dataclasses.replace(jrecipes.get(name), img_size=16,
                                  batch_size=3)
    root = layouts["jax", "coco"]
    _, val_ds, nc = tdatasets.make_datasets(recipe, root)
    ts = tloop.setup_state(recipe, tloop.model_config(recipe, nc),
                           tloop.make_optimizer(recipe), device="cpu")
    records = _recording(monkeypatch)
    if recipe.task == "panoptic":
        run = lambda mod, **kw: mod.evaluate_panoptic(  # noqa: E731
            recipe if mod is tev else jrecipe, root, None, **kw)
        first = tev.evaluate_panoptic(recipe, root, ts, device="cpu")
    else:
        run = lambda mod, **kw: mod.evaluate_instances(  # noqa: E731
            recipe if mod is tev else jrecipe, root, None, **kw)
        first = tev.evaluate_instances(recipe, root, ts, device="cpu")
    jval = jdatasets.make_datasets(jrecipe, root)[1]
    want_ids = [jval.image_id(i) for i in range(len(jval))]
    assert [i for _, ids, _ in records for i in ids][:len(val_ds)] == \
        want_ids and min(want_ids) >= 10000
    for k, batches in enumerate((list(records), _oracle(records))):
        _replay(monkeypatch, batches, tev)
        _replay(monkeypatch, batches, jev)
        got, want = run(tev, device="cpu"), run(jev)
        assert got == want
        if k == 0:
            assert got == first
    if recipe.task == "instance":
        assert got[recipe.eval_max_queries[-1]]["AP"] > 0
    else:
        assert got["pq"]["All"]["pq"] > 0.5


def test_train_on_fake_ade_layout(tmp_path, layouts):
    """`train()` reads the fake ADE layout; its first batch (the port's
    reader through the port's `BatchIterator`) equals JAX's."""
    recipe = dataclasses.replace(trecipes.get("ade_semantic"), img_size=16,
                                 batch_size=2)
    root = layouts["jax", "ade"]
    tds = tdatasets.make_datasets(recipe, root)[0]
    jds = jdatasets.make_datasets(dataclasses.replace(
        jrecipes.get("ade_semantic"), img_size=16), root)[0]
    got = next(tpipeline.BatchIterator(tds, 2, shuffle=True,
                                       seed=recipe.seed).epoch(0))
    want = next(jpipeline.BatchIterator(jds, 2, shuffle=True,
                                        seed=recipe.seed).epoch(0))
    _same_example(got, want)
    res = tloop.train(recipe, root, str(tmp_path), max_epochs=1,
                      eval_every=1, eval_max_batches=1, device="cpu",
                      verbose=False, save_checkpoints=False)
    (record,) = res.history
    assert record["step"] == N // 2
    assert all(math.isfinite(record[k]) for k in ("loss", "val_miou"))
