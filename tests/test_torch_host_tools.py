"""The port's host-side tools on the CPU: `eval_scale_bench` against the
JAX tool (tools/eval_scale_bench.py, imported by path) and `data_bench`
on a small fake ADE layout.

`synth_annotations` must draw the JAX tool's annotations exactly, RLEs
included, and `evaluate_ap` and `pq_compute` on them must give JAX's
numbers (both packages are exact host code). `main` prints the JAX
tool's JSON keys (its fixed 1,024 maps and 1,000 PQ images cut down
here). `data_bench.run` prints the JAX tool's keys and delivers
floor(n / batch) * batch images an epoch.
"""

import json
import shutil

import numpy as np
import pytest

from maskunet_tpu.evaluation import coco_eval as jcoco
from maskunet_tpu.evaluation import panoptic as jpan
from maskunet_tpu_torch.evaluation import coco_eval as tcoco
from maskunet_tpu_torch.evaluation import panoptic as tpan
from maskunet_tpu_torch.tools import data_bench, eval_scale_bench
from maskunet_tpu_torch.tools import make_fake_dataset

from test_torch_softmax_tools import _load_tool

JAX_EVAL_KEYS = {"n_images", "n_cats", "ap_seconds", "pq_1000img_seconds",
                 "inst_extract_img_per_sec", "ok"}
JAX_DATA_KEYS = {"dataset_images", "batch", "threads", "img_per_sec",
                 "host_cores"}


@pytest.fixture(scope="module")
def jax_tool():
    return _load_tool("eval_scale_bench")


def test_synth_annotations_equal_jax(jax_tool):
    got = eval_scale_bench.synth_annotations(5, 7)
    want = jax_tool.synth_annotations(5, 7)
    assert got == want
    assert len(got[0]) == 5 * 12 and len(got[1]) == 5 * 14


def test_ap_and_pq_equal_jax(jax_tool):
    gts, dts = eval_scale_bench.synth_annotations(5, 7)
    jgts, jdts = jax_tool.synth_annotations(5, 7)
    assert tcoco.evaluate_ap(gts, dts) == jcoco.evaluate_ap(jgts, jdts)
    # the JAX tool's PQ images, drawn as its main draws them
    rng = np.random.default_rng(2)
    want = []
    for _ in range(3):
        sem = rng.integers(0, 12, (128, 128)).astype(np.int32)
        pan, segs = jpan.semantic_to_panoptic((sem > 8) * sem)
        want.append((pan, segs, pan, segs))
    got = eval_scale_bench.pq_images(3)
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0]) and g[1] == w[1]
    assert tpan.pq_compute(got) == jpan.pq_compute(want)


def test_main_prints_the_jax_tools_keys(monkeypatch, capsys):
    maps, images = eval_scale_bench.instance_maps, eval_scale_bench.pq_images
    monkeypatch.setattr(eval_scale_bench, "instance_maps",
                        lambda: maps(8))
    monkeypatch.setattr(eval_scale_bench, "pq_images", lambda: images(2))
    row = eval_scale_bench.main(["4", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "native kernels: True"
    assert json.loads(lines[-1]) == row
    assert set(row) == JAX_EVAL_KEYS
    assert row["n_images"] == 4 and row["n_cats"] == 5 and row["ok"]


def test_data_bench_counts_whole_batches(tmp_path, capsys):
    root = str(tmp_path / "ade")
    make_fake_dataset.make_ade(root, n=18, size=32)
    try:
        rows = data_bench.run(root, 4, 1, (1, 2), device="cpu")
    finally:
        shutil.rmtree(root)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert [set(p) for p in printed] == [JAX_DATA_KEYS] * 2
    assert [p["threads"] for p in printed] == [1, 2]
    for p, r in zip(printed, rows):
        assert r == {**p, "images": 16}       # floor(18 / 4) * 4, 1 epoch
        assert p["dataset_images"] == 18 and p["img_per_sec"] > 0
    with pytest.raises(SystemExit, match="< batch"):
        make_fake_dataset.make_ade(root, n=2, size=32)
        try:
            data_bench.run(root, 4, 1, (1,), device="cpu")
        finally:
            shutil.rmtree(root)
