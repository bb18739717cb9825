"""The readers of the program's spans (`harness/spans.py` and the eight
metrics it serves) on hand-made device operations and span timelines."""

import re
import types

import pytest

from perfbench.harness import spans, spec

IDLE = ["idle_forward_ms.train", "idle_backward_ms.train",
        "idle_optimizer_ms.train", "idle_step_self_ms.train",
        "idle_feed_ms.train", "idle_outside_ms.train"]
READERS = IDLE + ["host_step_ms.train", "first_step_s.train"]
ME, OTHER = 7, 8


def rec(name, start_us, end_us, tid=ME, parent=None):
    """A span record with its stamps in ns on the trace's own clock."""
    return types.SimpleNamespace(name=name, parent=parent, tid=tid,
                                 start_ns=start_us * 1000,
                                 end_ns=end_us * 1000)


def trace_us(ns):
    return ns / 1000


# two steps; each hole of the ops below is given with its parts
RECORDS = [
    rec("feed.wait", -20, -5),
    rec("train.forward", 10, 40), rec("train.backward", 40, 80),
    rec("train.optimizer", 85, 95), rec("train.step", 0, 100),
    rec("feed.wait", 100, 105),
    rec("train.forward", 120, 150), rec("train.backward", 150, 170),
    rec("train.optimizer", 172, 180), rec("train.step", 110, 190),
    rec("train.step", 0, 300, tid=OTHER),
    rec("train.forward", 0, 300, tid=OTHER),
]
OPS = [("k", -30, 35), ("k", 20, 10), ("k", 50, 10), ("k", 90, 2),
       ("k", 130, 5), ("k", 132, 10), ("k", 160, 5), ("k", 200, 10)]
# holes: 5-20 (self 5, forward 10), 30-50 (forward 10, backward 10),
# 60-90 (backward 20, self 5, optimizer 5), 92-130 (optimizer 3, self 5,
# feed 5, outside 5, self 10, forward 10), 142-160 (forward 8,
# backward 10), 165-200 (backward 5, self 2, optimizer 8, self 10,
# outside 10)
WANT = {"forward": 38, "backward": 45, "optimizer": 16, "step_self": 37,
        "feed": 5, "outside": 15}


def _ctx(ops=OPS, kind="training", traced=True):
    trace = types.SimpleNamespace(ops=ops) if traced else None
    return types.SimpleNamespace(result={"kind": kind}, trace=trace,
                                 cell={"params": {"batch": 8}})


def _program(monkeypatch, records=RECORDS, totals=None, dropped=0):
    fake = types.SimpleNamespace(
        span_timeline=lambda: (list(records), dropped),
        span_totals=lambda: dict(totals or {}), trace_us=trace_us)
    monkeypatch.setattr(spans, "program", lambda: fake)


def test_idle_is_split_by_overlap_across_span_boundaries():
    split = spans.idle_split(OPS, RECORDS, trace_us)
    assert split == {k: v / 2 for k, v in WANT.items()}


def _idle_units(ops, lo, hi):
    """Idle us in [lo, hi), one us at a time."""
    return sum(1 for t in range(lo, hi)
               if not any(ts <= t < ts + d for _, ts, d in ops))


def test_the_six_readers_sum_to_the_stretchs_idle(monkeypatch):
    _program(monkeypatch)
    got = [spec.reader(name)(_ctx()) for name in IDLE]
    stretch = _idle_units(OPS, 0, 210)     # first step start, last op end
    assert sum(got) * 1e3 == stretch / 2
    assert got == [WANT[p] / 2 / 1e3 for p in
                   ("forward", "backward", "optimizer", "step_self",
                    "feed", "outside")]


def test_spans_of_other_names_are_transparent():
    extra = RECORDS + [rec("model.attn", 12, 38, parent="train.forward")]
    assert spans.idle_split(OPS, extra, trace_us) == \
        spans.idle_split(OPS, RECORDS, trace_us)


def test_host_step_ms_leaves_the_first_span_out(monkeypatch):
    total = types.SimpleNamespace(count=3, total_ns=9_000_000,
                                  first_ns=6_000_000)
    _program(monkeypatch, totals={"train.step": total})
    assert spec.reader("host_step_ms.train")(_ctx()) == pytest.approx(1.5)
    assert spec.reader("first_step_s.train")(_ctx()) == pytest.approx(0.006)
    one = types.SimpleNamespace(count=1, total_ns=5, first_ns=5)
    _program(monkeypatch, totals={"train.step": one})
    assert spec.reader("host_step_ms.train")(_ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_a_trace_or_spans(monkeypatch, name):
    read = spec.reader(name)
    _program(monkeypatch, records=[], totals={})
    assert read(_ctx()) is None
    _program(monkeypatch, totals={})
    assert read(_ctx(kind="serving")) is None
    if name in IDLE:
        assert read(_ctx(traced=False)) is None
        assert read(_ctx(ops=[])) is None
        _program(monkeypatch, dropped=1)
        assert read(_ctx()) is None
    monkeypatch.setattr(spans, "program", lambda: None)
    assert read(_ctx()) is None


def test_a_program_without_spans_gives_none(monkeypatch):
    """A program older than the spans has `utils.profiling` without them."""
    from maskunet_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_timeline")
    assert spans.program() is None
    assert spec.reader("idle_forward_ms.train")(_ctx()) is None


def test_every_span_the_program_opens_has_a_part():
    opened = set()
    for path in (spec.HERE.parent / "maskunet_tpu_torch").rglob("*.py"):
        opened |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert opened == set(spans.PARTS)
