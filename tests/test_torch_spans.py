"""The port's spans (`utils/profiling.span`): their totals with no
profiler, their timeline on the profiler's clock, and the spans of the
training step and the prefetcher."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from maskunet_tpu_torch.data import pipeline
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.train import step as tstep
from maskunet_tpu_torch.utils import profiling

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _names(records):
    return [r.name for r in records]


def test_without_a_profiler_spans_only_count(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(3):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    totals = profiling.span_totals()
    assert set(totals) == {"a", "b"}
    a = totals["a"]
    assert a.count == 3 and 0 < a.first_ns <= a.total_ns
    assert totals["a"].total_ns >= totals["b"].total_ns
    assert profiling.span_timeline() == ([], 0)


def _nested_spans(n):
    for i in range(n):
        with profiling.span(f"outer{i}"):
            with profiling.span(f"inner{i}"):
                torch.ones(8).sum()


def test_timeline_lands_on_the_profilers_clock(tmp_path):
    # a process's first profiled spans land late: warm up on the same body
    with profile(activities=CPU):
        _nested_spans(5)
    profiling.reset_spans()
    with profile(activities=CPU) as prof:
        _nested_spans(5)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    records, dropped = profiling.span_timeline()
    assert dropped == 0 and len(records) == 10
    assert trace["baseTimeNanoseconds"] == profiling.trace_base_ns(
        records[0].start_ns)
    for r in records:
        e = events[r.name]
        assert r.tid == e["tid"] == threading.get_native_id()
        assert abs(profiling.trace_us(r.start_ns) - e["ts"]) <= 50
        assert abs(profiling.trace_us(r.end_ns) - (e["ts"] + e["dur"])) \
            <= 50
        assert r.parent == (None if r.name.startswith("outer")
                            else "outer" + r.name[len("inner"):])
    # spans closed under the profiler stay out of the totals
    assert profiling.span_totals() == {}


def test_one_train_step_opens_its_spans_in_order():
    recipe = dataclasses.replace(trecipes.get("synthetic_semantic"),
                                 img_size=16, batch_size=2)
    cfg = tloop.model_config(recipe, 4)
    ts = tloop.setup_state(recipe, cfg, tloop.make_optimizer(recipe),
                           device="cpu")
    step = tstep.make_train_step(
        cfg, recipe.task_config,
        mask_plans=tmu.precompute_mask_plans(ts.masks), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (2, 16, 16, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 4, (2, 16, 16)))}
    ts, _ = step(ts, batch)
    totals = profiling.span_totals()
    assert {k: t.count for k, t in totals.items()} == {
        "train.step": 1, "train.forward": 1, "train.backward": 1,
        "train.optimizer": 1}
    with profile(activities=CPU):
        ts, _ = step(ts, batch)
    records, _ = profiling.span_timeline()
    by_start = sorted(records, key=lambda r: r.start_ns)
    assert _names(by_start) == ["train.step", "train.forward",
                                "train.backward", "train.optimizer"]
    outer = by_start[0]
    assert outer.parent is None
    for child in by_start[1:]:
        assert child.parent == "train.step"
        assert outer.start_ns <= child.start_ns <= child.end_ns \
            <= outer.end_ns
        assert child.tid == threading.get_native_id()
    for a, b in zip(by_start[1:], by_start[2:]):
        assert a.end_ns <= b.start_ns


def test_prefetcher_records_feed_wait():
    batches = ({"image": np.zeros((1, 4, 4, 3), np.uint8)} for _ in range(3))
    with pipeline.Prefetcher(batches, device="cpu") as feed:
        next(feed)
        with profile(activities=CPU):
            next(feed)
    assert profiling.span_totals()["feed.wait"].count == 1
    records, _ = profiling.span_timeline()
    assert _names(records) == ["feed.wait"]
    assert records[0].tid == threading.get_native_id()


def test_timeline_keeps_at_most_its_cap(monkeypatch):
    monkeypatch.setattr(profiling._SPANS, "cap", 3)
    with profile(activities=CPU):
        for _ in range(5):
            with profiling.span("s"):
                pass
    records, dropped = profiling.span_timeline()
    assert len(records) == 3 and dropped == 2
    profiling.reset_spans()
    assert profiling.span_timeline() == ([], 0)
