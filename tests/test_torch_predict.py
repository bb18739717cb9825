"""Prediction, visualisation and serving's dataset default in the port,
against the JAX package.

- `predict_directory` of both packages on the same images and the same
  eval-step outputs (a stand-in step that derives them from the image, so
  no model is compiled) writes the same mask PNGs, instance PNGs
  (connected components, or the DBSCAN of the embeddings: the port's on
  torch against scikit-learn's) and manifest byte for byte, and the same
  pixels in the panopticapi export and the panels.
- The port's `predict_directory` with its real eval step on the CPU (16 px,
  a fresh model, a padded last batch): each mask is the argmax of a
  direct eval forward of the same batch.
- `save_sample` / `save_prediction` draw the same pixels as JAX's, and
  raise naming matplotlib on a host without it.
- `serve` without `--num-classes` takes the dataset's count.
"""

import builtins
import dataclasses
import json
import os
import types

import cv2
import numpy as np
import pytest
import torch

from maskunet_tpu.tasks import datasets as jdatasets
from maskunet_tpu.tasks import predict as jpredict
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu.train import step as jstep
from maskunet_tpu.utils import visualize as jvis
from maskunet_tpu_torch import serve as tserve
from maskunet_tpu_torch.data import pipeline as tpipeline
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.tasks import predict as tpredict
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.tools import make_fake_dataset as tfake
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.train import step as tstep
from maskunet_tpu_torch.utils import visualize as tvis

IMG, NC = 24, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one host, and torch's default of a thread per core oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Three scenes of the fake-dataset painter, as JPEG and PNG."""
    d = tmp_path_factory.mktemp("imgs")
    for i in range(3):
        img, _, _ = tfake._paint_scene(np.random.default_rng(i), 30, 36, NC)
        ext = "jpg" if i % 2 else "png"
        cv2.imwrite(str(d / f"im{i}.{ext}"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return str(d)


def _outputs(image: np.ndarray, embed: bool) -> dict:
    """Eval-step outputs derived from the f32/255 images [B, H, W, 3]:
    classes from the colour, probabilities peaked at them, embeddings
    clumped per class."""
    q = np.round(image * 255).astype(np.int64)
    pred = (q[..., 0] // 64 + q[..., 1] // 128) % NC
    prob = np.full(pred.shape + (NC,), 0.2 / (NC - 1), np.float32)
    np.put_along_axis(prob, pred[..., None], 0.8, axis=-1)
    out = {"pred": pred, "prob": prob}
    if embed:
        emb = np.eye(16, dtype=np.float32)[pred] * 3
        out["embeddings"] = emb + 0.01 * np.sin(
            np.arange(emb.size, dtype=np.float32)).reshape(emb.shape)
    return out


def _fake_step(embed: bool, port: bool):
    def step(ts, batch, plans):
        image = batch["image"]
        out = _outputs(image.numpy() if port else np.asarray(image), embed)
        return {k: torch.from_numpy(v) for k, v in out.items()} if port \
            else out
    return lambda *a, **k: step


@pytest.mark.parametrize("name", ["ade_panoptic", "city_instance"])
def test_predict_directory_writes_what_jax_writes(monkeypatch, tmp_path,
                                                  image_dir, name):
    embed = trecipes.get(name).embed_dim > 0
    monkeypatch.setattr(tstep, "cached_eval_step", _fake_step(embed, True))
    monkeypatch.setattr(jstep, "cached_eval_step", _fake_step(embed, False))
    stub = types.SimpleNamespace(masks=None)
    kw = dict(num_classes=NC, save_instances=True, save_panoptic=True,
              save_panels=name == "ade_panoptic")
    outs = {}
    for pkg, mod, recipes in (("port", tpredict, trecipes),
                              ("jax", jpredict, jrecipes)):
        rec = dataclasses.replace(recipes.get(name), img_size=IMG,
                                  batch_size=2)
        out = str(tmp_path / pkg)
        extra = {"device": "cpu"} if pkg == "port" else {}
        written = mod.predict_directory(rec, stub, image_dir, out, **kw,
                                        **extra)
        assert [os.path.basename(p) for p in written] == [
            f"im{i}_mask.png" for i in range(3)]
        outs[pkg] = out
    files = sorted(os.path.relpath(os.path.join(d, f), outs["jax"])
                   for d, _, fs in os.walk(outs["jax"]) for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), outs["port"])
        for d, _, fs in os.walk(outs["port"]) for f in fs)
    assert ("im0_panel.png" in files) == (name == "ade_panoptic")
    for f in files:
        a, b = (os.path.join(outs[k], f) for k in ("port", "jax"))
        if f == "predictions.json":
            got, want = json.load(open(a)), json.load(open(b))
            got["files"] = [os.path.basename(p) for p in got["files"]]
            want["files"] = [os.path.basename(p) for p in want["files"]]
            assert got == want and got["instances"]
        elif f.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b))
        elif f.endswith("_panel.png") or f.startswith("panoptic"):
            # panels: matplotlib; the port's panoptic PNG encoder is its
            # own (evaluation/panoptic.py): the same pixels
            assert np.array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(b, cv2.IMREAD_UNCHANGED)), f
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f
    inst = cv2.imread(os.path.join(outs["port"], "im1_instances.png"),
                      cv2.IMREAD_UNCHANGED)
    assert inst.dtype == np.uint16 and inst.max() > 0


def test_predict_directory_masks_are_the_eval_forward(tmp_path, image_dir):
    rec = dataclasses.replace(trecipes.get("ade_semantic"), img_size=16,
                              batch_size=2)
    cfg = tloop.model_config(rec, NC)
    ts = tloop.setup_state(rec, cfg, tloop.make_optimizer(rec),
                           device="cpu")
    written = tpredict.predict_directory(rec, ts, image_dir,
                                         str(tmp_path / "out"),
                                         num_classes=NC, device="cpu")
    ds = tpredict._DirectoryDataset(image_dir, 16)
    want = []
    for batch in tpipeline.BatchIterator(ds, 2, shuffle=False,
                                         drop_last=False,
                                         pad_last=True).epoch(0):
        x = tpipeline.to_device(batch, "cpu")["image"]
        with torch.no_grad():
            out, _ = tmu.apply(ts.params, ts.model_state, x, cfg=cfg,
                               masks=ts.masks, train=False)
        want += list(out.semantic.argmax(-1).numpy()[batch["valid"]])
    assert len(written) == len(want) == 3
    for path, w in zip(written, want):
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), w)


def test_panels_equal_jax_and_name_a_missing_matplotlib(monkeypatch,
                                                        tmp_path):
    rng = np.random.default_rng(0)
    ex = {"image": rng.integers(0, 255, (12, 12, 3)).astype(np.uint8),
          "label": rng.integers(0, NC, (12, 12)),
          "instance": rng.integers(0, 3, (12, 12))}
    for name, call in (
            ("sample", lambda vis, p: vis.save_sample(ex, p)),
            ("pred", lambda vis, p: vis.save_prediction(
                ex["image"] / 255.0, ex["label"], ex["instance"], p))):
        paths = [str(tmp_path / f"{name}_{k}.png") for k in "tj"]
        call(tvis, paths[0])
        call(jvis, paths[1])
        assert np.array_equal(cv2.imread(paths[0]), cv2.imread(paths[1]))
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ModuleNotFoundError, match="need matplotlib"):
        tvis.save_prediction(ex["image"], ex["label"], ex["label"],
                             str(tmp_path / "none.png"))
    assert not os.path.exists(tmp_path / "none.png")


def test_serve_num_classes_defaults_to_the_dataset(monkeypatch, tmp_path):
    root = str(tmp_path / "ade")
    tfake.make_ade(root, n=4, size=16, num_classes=9)
    seen = []

    class Stop(Exception):
        pass

    def runner(recipe, num_classes, *a, **k):
        seen.append(num_classes)
        raise Stop

    monkeypatch.setattr(tserve, "build_model_runner", runner)
    for argv in (["--data-root", root], ["--num-classes", "4"]):
        with pytest.raises(Stop):
            tserve.main(["--recipe", "ade_semantic", "--device", "cpu",
                         "--workdir", str(tmp_path / "w"), *argv])
    want = jdatasets.make_datasets(jrecipes.get("ade_semantic"), root)[2]
    assert seen == [want, 4] and want == 9
