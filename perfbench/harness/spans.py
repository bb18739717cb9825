"""The program's own spans against the profiled stretch's device work.

The port opens spans inside its training step and its feed
(`maskunet_tpu_torch.utils.profiling.span`): `train.step` around a step,
inside it `train.forward`, `train.backward` and `train.optimizer`, and
`feed.wait` where the consumer waits on the prefetcher's queue. It keeps
their totals in memory (spans closed with no profiler running) and,
under a profiler, a timeline stamped on the wall clock that
`profiling.trace_us` puts on the Chrome trace's clock.

The idle split: the stretch runs from the first `train.step` start to
the last device operation's end (`Trace.ops`: the operations launched
inside the harness's call spans). Each hole in the union of those
operations is split across the innermost span open on the thread that
opened the most `train.step` spans, by overlap, and divided by the number of
`train.step` spans. `PARTS` name the six parts: a span's own, the
step's self time (`step_self`) and no span at all (`outside`), so the
parts sum to the stretch's idle time a step.

A program without these spans (one older than them) gives no timeline;
every reader then returns None.
"""

from __future__ import annotations

import collections

STEP = "train.step"
PARTS = {"train.forward": "forward", "train.backward": "backward",
         "train.optimizer": "optimizer", STEP: "step_self",
         "feed.wait": "feed"}
OUTSIDE = "outside"


def program():
    """The port's profiling module where it has spans, else None."""
    try:
        from maskunet_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, n) for n in
               ("span_totals", "span_timeline", "trace_us")):
        return None
    return profiling


def _segments(spans: list[tuple[float, float, str]]
              ) -> list[tuple[float, float, str]]:
    """(start, end, part) of the innermost span at each time, for spans
    of one thread (which nest)."""
    # at one time ends go first, and the outer of two spans opens first
    events = sorted([(s, 1, -e, i) for i, (s, e, _) in enumerate(spans)]
                    + [(e, 0, 0, i) for i, (_, e, _) in enumerate(spans)])
    segs, stack, prev = [], [], None
    for t, opens, _, i in events:
        if stack and t > prev:
            segs.append((prev, t, spans[stack[-1]][2]))
        prev = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return segs


def _holes(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The holes in the union of `ops` ((name, ts, dur) us) in [lo, hi]."""
    holes, at = [], lo
    for s, e in sorted((ts, ts + dur) for _, ts, dur in ops):
        if s > at:
            holes.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        holes.append((at, hi))
    return [(s, e) for s, e in holes if e > s]


def idle_split(ops, records, trace_us) -> dict[str, float] | None:
    """Idle us a step in each part (`PARTS`' values and `OUTSIDE`), from
    the device operations `ops` ((name, ts us, dur us)) and the span
    records `records` (`profiling.SpanRecord`s; `trace_us` converts
    their stamps). None without a `train.step` span or an operation."""
    tids = collections.Counter(r.tid for r in records if r.name == STEP)
    if not tids or not ops:
        return None
    tid, n = tids.most_common(1)[0]
    mine = [(trace_us(r.start_ns), trace_us(r.end_ns), PARTS[r.name])
            for r in records if r.tid == tid and r.name in PARTS]
    lo = min(s for s, _, part in mine if part == PARTS[STEP])
    hi = max(ts + dur for _, ts, dur in ops)
    split = dict.fromkeys([*PARTS.values(), OUTSIDE], 0.0)
    segs = _segments(mine)
    j = 0
    for s, e in _holes(ops, lo, hi):
        covered = 0.0
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            overlap = min(e, segs[k][1]) - max(s, segs[k][0])
            if overlap > 0:
                split[segs[k][2]] += overlap
                covered += overlap
            k += 1
        split[OUTSIDE] += (e - s) - covered
    return {k: v / n for k, v in split.items()}


def idle_ms(ctx, part: str) -> float | None:
    """The reader of `idle_<part>_ms.train`: ms a step of the stretch's
    idle time under `part`."""
    prof = program()
    if ctx.result["kind"] != "training" or ctx.trace is None or \
            prof is None:
        return None
    records, dropped = prof.span_timeline()
    if dropped:
        return None
    split = idle_split(ctx.trace.ops, records, prof.trace_us)
    return None if split is None else split[part] / 1e3


def step_total(ctx):
    """The `train.step` totals (`profiling.SpanTotal`), or None."""
    prof = program()
    if ctx.result["kind"] != "training" or prof is None:
        return None
    return prof.span_totals().get(STEP)
