"""The panoptic and instance slice as a whole: training with validation,
and the evaluators against the JAX package's on the same host arrays.

- The port's `train()` of synthetic_panoptic at 16 px (64 examples, batch
  8: 8 steps) for one epoch with `eval_every=1` records finite val_pq and
  val_ap, equal to the port's `evaluate_panoptic` of the returned state
  over the same batches.
- Each evaluator of the port runs on its own host batches (its eval step
  on the CPU at 16 px, batch 6 over the 16 validation examples, so the
  last batch is padded); the batches are recorded at the `_iter_eval`
  seam and replayed through the JAX package's `_iter_eval`, so its
  evaluation functions decode the same predictions. AP, PQ and mIoU must
  be equal: panoptic (connected components, fusion, PQ), instances from
  the argmax map (ade_instance), and instances from the embeddings
  (city_instance: the port's DBSCAN against scikit-learn). No JAX model
  is compiled.
- A model this small predicts no instance well, so the same comparison
  runs again on oracle batches (the predictions are the labels, the
  embeddings clumps around a point per instance id), replayed to both
  packages: AP near 1 must be equal too.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from maskunet_tpu.tasks import evaluators as jev
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu_torch.tasks import datasets as tdatasets
from maskunet_tpu_torch.tasks import evaluators as tev
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop

SMALL = dict(img_size=16, dataset="synthetic")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host, and torch's default of a thread per core in each
    oversubscribes it (a 16 px `train()` then runs ~10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    recipe = dataclasses.replace(trecipes.get("synthetic_panoptic"), **SMALL)
    return tloop.train(recipe, None, str(tmp_path_factory.mktemp("pan")),
                       max_epochs=1, eval_every=1, eval_max_batches=1,
                       device="cpu", verbose=False, save_checkpoints=False)


def test_train_validates_panoptic_recipe(trained):
    recipe = dataclasses.replace(trecipes.get("synthetic_panoptic"), **SMALL)
    (record,) = trained.history
    assert {"val_loss", "val_triplet_loss", "val_miou", "val_pq",
            "val_ap"} <= set(record)
    assert all(math.isfinite(record[k]) for k in ("val_pq", "val_ap"))
    pan = tev.evaluate_panoptic(recipe, None, trained.state, max_batches=1,
                                device="cpu")
    assert record["val_pq"] == pan["pq"]["All"]["pq"]
    assert record["val_ap"] == pan["ap"]["AP"]


def _recording(monkeypatch):
    records = []
    inner = tev._iter_eval

    def recording(*args, **kw):
        for item in inner(*args, **kw):
            records.append(item)
            yield item

    monkeypatch.setattr(tev, "_iter_eval", recording)
    return records


def _replay(monkeypatch, records, module=jev):
    """Replays the port's (indices, image ids, host) batches into
    `module`'s `_iter_eval`: into JAX's with a numpy host."""
    def replay(*args, **kw):
        for indices, ids, host in records:
            if module is tev:
                yield indices, ids, host
                continue
            yield indices, ids, {
                k: v.numpy() if torch.is_tensor(v) else v
                for k, v in host.items()}

    monkeypatch.setattr(module, "_iter_eval", replay)


@pytest.mark.parametrize("name", ["synthetic_panoptic", "ade_instance",
                                  "city_instance"])
def test_evaluators_match_jax_on_the_same_batches(monkeypatch, trained,
                                                  name):
    recipe = dataclasses.replace(trecipes.get(name), batch_size=6, **SMALL)
    jrecipe = dataclasses.replace(jrecipes.get(name), batch_size=6, **SMALL)
    _, val_ds, nc = tdatasets.make_datasets(recipe, None)
    if name == "synthetic_panoptic":
        ts = trained.state
    else:
        cfg = tloop.model_config(recipe, nc)
        ts = tloop.setup_state(recipe, cfg, tloop.make_optimizer(recipe),
                               device="cpu")
    records = _recording(monkeypatch)
    _replay(monkeypatch, records)
    if recipe.task == "panoptic":
        got = tev.evaluate_panoptic(recipe, None, ts, device="cpu")
        want = jev.evaluate_panoptic(jrecipe, None, None,
                                     dataset=(val_ds, nc))
        assert got["pq"]["All"]["n"] > 0
    else:
        got = tev.evaluate_instances(recipe, None, ts, device="cpu")
        want = jev.evaluate_instances(jrecipe, None, None,
                                      dataset=(val_ds, nc))
        assert set(got) == set(recipe.eval_max_queries)
    assert len(records) == 3 and records[-1][2]["valid"].sum() == 4
    assert ("embeddings" in records[0][2]) == (recipe.embed_dim > 0)
    assert got == want


def _oracle_records(ds, nc, rng, embed_dim):
    records = []
    for start in range(0, len(ds), 6):
        idx = list(range(start, min(start + 6, len(ds))))
        label = np.stack([ds[i]["label"] for i in idx])
        inst = np.stack([ds[i]["instance"] for i in idx])
        prob = rng.random(label.shape + (nc,)).astype(np.float32)
        host = {"pred": label.astype(np.int64), "prob": prob,
                "label": label, "valid": np.ones(len(idx), bool),
                "instance": inst}
        if embed_dim:
            centers = rng.standard_normal((inst.max() + 1, embed_dim)) * 3
            emb = centers[inst] + rng.standard_normal(
                inst.shape + (embed_dim,)) * 0.05
            host["embeddings"] = torch.from_numpy(emb.astype(np.float32))
        records.append((idx, idx, host))
    return records


@pytest.mark.parametrize("name", ["synthetic_panoptic", "city_instance"])
def test_evaluators_match_jax_on_oracle_predictions(monkeypatch, rng, name):
    recipe = dataclasses.replace(trecipes.get(name), batch_size=6, **SMALL)
    jrecipe = dataclasses.replace(jrecipes.get(name), batch_size=6, **SMALL)
    _, val_ds, nc = tdatasets.make_datasets(recipe, None)
    records = _oracle_records(val_ds, nc, rng, recipe.embed_dim)
    _replay(monkeypatch, records, tev)
    _replay(monkeypatch, records)
    if recipe.task == "panoptic":
        got = tev.evaluate_panoptic(recipe, None, None, device="cpu")
        want = jev.evaluate_panoptic(jrecipe, None, None,
                                     dataset=(val_ds, nc))
        assert got["pq"]["All"]["pq"] > 0.9
        ap = got["ap"]["AP"]
    else:
        got = tev.evaluate_instances(recipe, None, None, device="cpu")
        want = jev.evaluate_instances(jrecipe, None, None,
                                      dataset=(val_ds, nc))
        ap = got[100]["AP"]
    assert ap > 0.5
    assert got == want


def test_coco_instance_ground_truth_waits_for_the_data_slice():
    """The data slice has landed: the COCO instance ground truth is read
    from the layout under data_root, so a missing layout raises as JAX's
    does (tests/test_torch_datasets.py evaluates a real one)."""
    for module, recipes_mod in ((tev, trecipes), (jev, jrecipes)):
        kw = {"device": "cpu"} if module is tev else {}
        with pytest.raises(FileNotFoundError):
            module.evaluate_instances(recipes_mod.get("coco_instance"),
                                      "/nonexistent", None, **kw)
