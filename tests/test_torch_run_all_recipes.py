"""The port's tools/run_all_recipes.py on the CPU.

- One panoptic and one instance recipe (coco_panoptic, coco_instance),
  run by the port's `run_recipe` for 1 epoch at 16 px on a small fake COCO
  layout, give rows with the keys of the JAX tool's rows: those that
  `recipes_e2e.json` records, and exactly those that the JAX tool's
  `run_recipe` builds (its training and evaluation replaced by stubs, so
  no JAX model is compiled).
- `--require-nonzero` fails a run with a zero PQ or AP, and a failed
  recipe fails the run with or without it, as in the JAX tool.
"""

import dataclasses
import importlib.util
import json
import math
import os
import types

import pytest
import torch

from maskunet_tpu.tasks import evaluators as jev
from maskunet_tpu.train import loop as jloop
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.tools import make_fake_dataset as tfake
from maskunet_tpu_torch.tools import run_all_recipes as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ("coco_panoptic", "coco_instance")
N = 4               # training images; the fake tool writes 4 validation
LR = 1e-3           # the demo lr that recipes_e2e.json records


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recipes") / "coco")
    tfake.make_coco(root, n=N, size=40)
    return root


def _jax_row_keys(monkeypatch, name: str) -> set:
    """The keys of the JAX tool's row for `name`, with `train` and the
    evaluators replaced by stubs."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_all_recipes", os.path.join(REPO, "tools",
                                            "run_all_recipes.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    result = types.SimpleNamespace(
        history=[{"loss": 1.0, "miou": 0.5}], state=None, best_state=None,
        stop_reason="max_epochs", best_iou=0.5, images_per_sec=1.0)
    monkeypatch.setattr(tool, "ensure_data", lambda kind, n=24: "unused")
    monkeypatch.setattr(jloop, "train", lambda *a, **k: result)
    monkeypatch.setattr(jev, "evaluate_semantic",
                        lambda *a, **k: {"miou": 0.5, "loss": 1.0})
    monkeypatch.setattr(jev, "evaluate_panoptic", lambda *a, **k: {
        "pq": {"All": {"pq": 0.5}}, "ap": {"AP": 0.5}})
    monkeypatch.setattr(jev, "evaluate_instances",
                        lambda *a, max_queries, **k: {
                            max_queries[0]: {"AP": 0.5}})
    return set(tool.run_recipe(name, 1, n_data=N, lr=LR))


@pytest.mark.parametrize("name", RECIPES)
def test_run_recipe_rows_have_the_jax_tools_keys(monkeypatch, coco_root,
                                                 name):
    get = trecipes.get
    monkeypatch.setattr(trecipes, "get", lambda n: dataclasses.replace(
        get(n), img_size=16, batch_size=2))
    monkeypatch.setattr(trun, "ensure_data", lambda kind, n=24: coco_root)
    row = trun.run_recipe(name, 1, n_data=N, lr=LR, device="cpu")

    with open(os.path.join(REPO, "recipes_e2e.json")) as f:
        (recorded,) = [r for r in json.load(f)["rows"]
                       if r["recipe"] == name]
    assert set(recorded) <= set(row)
    assert set(row) == _jax_row_keys(monkeypatch, name)
    assert row["epochs_run"] == 1 and row["lr_override"] == LR
    assert all(math.isfinite(row[k]) for k in ("train_loss", "val_loss"))
    assert 0.0 <= row["val_miou"] <= 1.0 and 0.0 <= row["ap"] <= 1.0
    if name == "coco_panoptic":
        assert 0.0 <= row["pq"] <= 1.0 and row["exported"] is True


_OK = {"coco_panoptic": {"pq": 0.2, "pq_things": 0.1, "ap": 0.3},
       "coco_instance": {"ap": 0.4}}


@pytest.mark.parametrize("metrics, flags, code", [
    (_OK, ["--require-nonzero"], None),
    ({**_OK, "coco_panoptic": {**_OK["coco_panoptic"], "pq": 0.0}},
     ["--require-nonzero"], 1),
    ({**_OK, "coco_instance": {"ap": 0.0}}, ["--require-nonzero"], 1),
    ({**_OK, "coco_instance": {"ap": 0.0}}, [], None),
    ({**_OK, "coco_instance": None}, [], 1),
], ids=["nonzero", "zero-pq", "zero-ap", "zero-ap-not-required",
        "failed-recipe"])
def test_require_nonzero_fails_a_zero_metric(monkeypatch, tmp_path, metrics,
                                             flags, code):
    def run_recipe(name, epochs, **kw):
        if metrics[name] is None:
            raise RuntimeError("recipe failed")
        return {"recipe": name, **metrics[name]}

    monkeypatch.setattr(trun, "run_recipe", run_recipe)
    out = tmp_path / "rows.json"
    argv = ["--only", *RECIPES, "--out", str(out), "--device", "cpu",
            *flags]
    if code is None:
        trun.main(argv)
    else:
        with pytest.raises(SystemExit) as exc:
            trun.main(argv)
        assert exc.value.code == code
    with open(out) as f:
        rows = json.load(f)["rows"]
    assert sorted(r["recipe"] for r in rows) == sorted(RECIPES)
    for r in rows:
        assert ("error" in r) == (metrics[r["recipe"]] is None)
