"""The port's data path (maskunet_tpu_torch.data, tasks.datasets) against
the JAX package's, on the CPU: the same synthetic examples byte for byte,
the same batches (order, padding, `valid`) for a seed and epoch, the same
subsets, and the prefetcher's behaviour of tests/test_data.py."""

import dataclasses

import numpy as np
import pytest
import torch

from maskunet_tpu.data import cache as jcache
from maskunet_tpu.data import pipeline as jpipeline
from maskunet_tpu.data import subset as jsubset
from maskunet_tpu.data import synthetic as jsynthetic
from maskunet_tpu.tasks import datasets as jdatasets
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu_torch.data import cache as tcache
from maskunet_tpu_torch.data import pipeline as tpipeline
from maskunet_tpu_torch.data import subset as tsubset
from maskunet_tpu_torch.data import synthetic as tsynthetic
from maskunet_tpu_torch.tasks import datasets as tdatasets
from maskunet_tpu_torch.tasks import recipes as trecipes


def _same_example(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kw", [
    dict(img_size=32, num_classes=8, seed=42),
    dict(img_size=16, num_classes=150, seed=43, with_instance=True),
    dict(img_size=24, num_classes=5, seed=0, ignore_border=True,
         num_objects=7),
])
def test_synthetic_examples_equal_jax_byte_for_byte(kw):
    j = jsynthetic.SyntheticSegmentationDataset(num_examples=6, **kw)
    t = tsynthetic.SyntheticSegmentationDataset(num_examples=6, **kw)
    assert len(t) == len(j) and t.things_labels == j.things_labels
    np.testing.assert_array_equal(t.class_colors, j.class_colors)
    for i in range(len(j)):
        _same_example(t[i], j[i])
        assert t.image_id(i) == j.image_id(i)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=1, drop_last=True),
    dict(batch_size=4, shuffle=False, drop_last=False, pad_last=True),
    dict(batch_size=3, shuffle=True, seed=7, drop_last=False),
])
def test_batch_iterator_equals_jax_over_three_epochs(kw):
    """Order, padding and `valid` of every batch, epochs 0-2."""
    ds = tsynthetic.SyntheticSegmentationDataset(num_examples=10,
                                                 img_size=16)
    jds = jsynthetic.SyntheticSegmentationDataset(num_examples=10,
                                                  img_size=16)
    t = tpipeline.BatchIterator(ds, num_threads=2, **kw)
    j = jpipeline.BatchIterator(jds, num_threads=2, **kw)
    assert len(t) == len(j)
    for epoch in range(3):
        tb, jb = list(t.epoch(epoch)), list(j.epoch(epoch))
        assert len(tb) == len(jb) == len(j)
        for a, b in zip(tb, jb):
            _same_example(a, b)


def test_datasets_synthetic_equal_jax_and_real_ones_wait():
    jr = dataclasses.replace(jrecipes.get("ade_semantic"),
                             dataset="synthetic", num_classes=150,
                             img_size=16)
    tr = dataclasses.replace(trecipes.get("ade_semantic"),
                             dataset="synthetic", num_classes=150,
                             img_size=16)
    jtrain, jval, jn = jdatasets.make_datasets(jr, None)
    ttrain, tval, tn = tdatasets.make_datasets(tr, None)
    assert (tn, len(ttrain), len(tval)) == (jn, len(jtrain), len(jval)) \
        == (150, 64, 16)
    for i in (0, 63):
        _same_example(ttrain[i], jtrain[i])
    _same_example(tval[15], jval[15])
    # the real readers came with the data slice: a missing layout raises
    # as JAX's does (tests/test_torch_datasets.py reads real layouts)
    for name in ("ade_semantic", "coco_panoptic", "city_semantic"):
        for datasets, recipes in ((tdatasets, trecipes),
                                  (jdatasets, jrecipes)):
            with pytest.raises(FileNotFoundError):
                datasets.make_datasets(recipes.get(name), "/nonexistent")


@pytest.mark.parametrize("fraction", [0.1, 0.5, 1.0])
def test_fraction_subset_equals_jax(fraction):
    ds = tsynthetic.SyntheticSegmentationDataset(num_examples=16, img_size=8)
    jds = jsynthetic.SyntheticSegmentationDataset(num_examples=16,
                                                  img_size=8)
    t = tsubset.FractionSubset(ds, fraction, seed=3)
    j = jsubset.FractionSubset(jds, fraction, seed=3)
    np.testing.assert_array_equal(t.indices, j.indices)
    for i in range(len(t)):
        assert t.image_id(i) == int(t.indices[i]) == j.image_id(i)
        _same_example(t[i], j[i])
    assert t.num_classes == 8            # metadata delegation
    with pytest.raises(ValueError, match="fraction"):
        tsubset.FractionSubset(ds, 0.0)


def test_cached_dataset():
    class Counting:
        def __init__(self):
            self.calls = 0
            self.num_classes = 5

        def __len__(self):
            return 4

        def __getitem__(self, i):
            self.calls += 1
            return {"image": np.full((2, 2, 3), i, np.uint8)}

    for module in (tcache, jcache):
        base = Counting()
        ds = module.CachedDataset(base)
        a, b = ds[1], ds[1]
        np.testing.assert_array_equal(a["image"], b["image"])
        assert base.calls == 1 and len(ds) == 4 and ds.num_classes == 5
        capped = module.CachedDataset(Counting(), max_examples=1)
        capped[0], capped[1], capped[1]
        assert capped.dataset.calls == 3


def test_to_device_scales_uint8_and_keeps_other_dtypes():
    batch = {"image": np.arange(12, dtype=np.uint8).reshape(1, 2, 2, 3) * 20,
             "label": np.arange(4, dtype=np.int32).reshape(1, 2, 2),
             "valid": np.array([True])}
    out = tpipeline.to_device(batch, "cpu")
    want = jpipeline.to_device(batch)
    assert out["image"].dtype == torch.float32
    np.testing.assert_array_equal(out["image"].numpy(),
                                  np.asarray(want["image"]))
    assert out["label"].dtype == torch.int32
    np.testing.assert_array_equal(out["label"].numpy(), batch["label"])
    assert out["valid"].dtype == torch.bool
    out["label"][0, 0, 0] = 99           # a copy, not a view of the batch
    assert batch["label"][0, 0, 0] == 0


def test_prefetcher_end_to_end():
    ds = tsynthetic.SyntheticSegmentationDataset(num_examples=8, img_size=16)
    it = tpipeline.BatchIterator(ds, 4, shuffle=False)
    with tpipeline.Prefetcher(it.epoch(0), device="cpu") as pf:
        got = list(pf)
    want = list(it.epoch(0))
    assert len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"].numpy(),
                                      b["image"].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])


def test_prefetcher_early_exit_releases_worker():
    """Breaking out of a Prefetcher stops the worker thread instead of
    leaking it blocked on a full queue."""
    ds = tsynthetic.SyntheticSegmentationDataset(num_examples=64, img_size=8)
    it = tpipeline.BatchIterator(ds, 2, shuffle=False)
    with tpipeline.Prefetcher(it.epoch(0), device="cpu") as pf:
        next(pf)   # consume one of 32 batches, then exit early
        worker = pf._thread
    worker.join(timeout=10)
    assert not worker.is_alive()


def test_prefetcher_raises_the_workers_error():
    def broken():
        yield {"image": np.zeros((1, 2, 2, 3), np.uint8)}
        raise OSError("decode failed")

    with tpipeline.Prefetcher(broken(), device="cpu") as pf:
        next(pf)
        with pytest.raises(OSError, match="decode failed"):
            next(pf)
