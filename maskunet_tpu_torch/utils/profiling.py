"""Profiling and debugging hooks.

Counterpart of maskunet_tpu/utils/profiling.py:

- `trace(logdir)`: context manager around `torch.profiler` (CPU, and the
  card's kernels where there is one) that writes a Chrome trace,
  ``trace.json``, into `logdir` (chrome://tracing or Perfetto open it).
- `nan_guard(tensors, where)`: host-side finite check on a dict of
  tensors; the error names the offending entry.
- `StallWatchdog`: detects a hung device step and surfaces it instead of
  letting the training process block forever inside a device sync that
  Python cannot interrupt (this package's own copy of the JAX one).
- `device_ms_per_call(fn)`: the card's kernel time a call, by the
  profiler (the tools' device times).
- `span(name)`: a named stretch of the program's host work. Every span
  adds to its name's totals (`span_totals`); while a profiler runs it
  also opens `torch.profiler.record_function(name)`, so it shows in the
  trace, and lands in an in-memory timeline (`span_timeline`) stamped on
  the wall clock, which `trace_us` puts on the Chrome trace's clock.
  The training step opens `train.step`, `train.forward`,
  `train.backward` and `train.optimizer` (`train/step.py`), the
  prefetcher `feed.wait` (`data/pipeline.py`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Callable, Iterator, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class NonFiniteError(RuntimeError):
    pass


def nan_guard(tensors: dict, where: str = "") -> None:
    for name, value in tensors.items():
        if not bool(torch.isfinite(torch.as_tensor(value).float()).all()):
            raise NonFiniteError(
                f"non-finite value in {name} at {where or 'step'}")


class StallWatchdog:
    """Fail-fast detection for a hung device step (the reference has none,
    and a blocked device sync is not interruptible from Python once the
    device stops answering).

    A daemon thread watches the gap since the last `beat()`. When it
    exceeds `timeout_s` it prints a loud stderr diagnostic (elapsed,
    last context string) and either keeps warning every `timeout_s`
    (`abort=False`, the default: kernel builds and large steps are
    legitimately slow, so killing is opt-in) or hard-exits the process
    with status 42 (`abort=True`) so a supervisor can restart the run
    with `--resume`, since the blocked sync itself can never raise.

    Zero overhead on the step path: `beat()` is one monotonic read and
    one attribute store, no locks.
    """

    EXIT_CODE = 42

    def __init__(self, timeout_s: float, *, abort: bool = False,
                 on_stall: Callable[[float, str], None] | None = None,
                 poll_s: float | None = None):
        self.timeout_s = float(timeout_s)
        self.abort = abort
        self.on_stall = on_stall
        self._poll_s = poll_s if poll_s is not None else min(
            self.timeout_s / 4.0, 10.0)
        self._last = time.monotonic()
        self._context = "startup"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._paused = False
        self.stalls = 0

    def beat(self, context: str = "") -> None:
        self._last = time.monotonic()
        if context:
            self._context = context

    def pause(self, context: str = "") -> None:
        """Suspend stall detection (epoch-end validation / checkpoint
        windows are legitimately longer than a step timeout sized for the
        step loop). `resume()` re-arms with a fresh clock."""
        self._paused = True
        if context:
            self._context = context

    def resume(self) -> None:
        self._last = time.monotonic()
        self._paused = False

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            if self._paused:
                continue
            elapsed = time.monotonic() - self._last
            if elapsed < self.timeout_s:
                continue
            self.stalls += 1
            msg = (f"[watchdog] no step progress for {elapsed:.0f}s "
                   f"(timeout {self.timeout_s:.0f}s) — last progress: "
                   f"{self._context}. The device may be hung; a blocked "
                   f"device sync cannot be interrupted from Python.")
            print(msg, file=sys.stderr, flush=True)
            if self.on_stall is not None:
                self.on_stall(elapsed, self._context)
            if self.abort:
                print(f"[watchdog] aborting with exit code "
                      f"{self.EXIT_CODE} — restart with --resume to "
                      f"recover from the last checkpoint",
                      file=sys.stderr, flush=True)
                sys.stderr.flush()
                os._exit(self.EXIT_CODE)
            # warn-only: reset the clock so the warning repeats once per
            # timeout window instead of once per poll tick
            self._last = time.monotonic()

    def __enter__(self) -> "StallWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_s + 1.0)


def device_ms_per_call(fn: Callable[[], object], calls: int = 3
                       ) -> float | None:
    """The card's kernel time a call of `fn`: the profiler's sum of device
    kernel times over `calls` calls (a user annotation on the device spans
    kernels that are counted already), divided by `calls`. A host-bound
    call leaves the card idle between launches; this counts only its busy
    time. None on the CPU, or where the profiler saw no kernel."""
    if not torch.cuda.is_available():
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0 and not e.is_user_annotation)
    return us / calls / 1e3 if us else None


# Kineto rounds a trace's base time (`baseTimeNanoseconds` of the Chrome
# export) down to a multiple of this many seconds, and writes every `ts`
# in us after it.
_TRACE_BASE_S = 7889238
_TIMELINE_CAP = 100_000


class SpanTotal(NamedTuple):
    count: int
    total_ns: int
    first_ns: int


class SpanRecord(NamedTuple):
    name: str
    parent: str | None      # the span open around it on its thread
    tid: int                # native thread id, as the Chrome trace's
    start_ns: int           # time.time_ns()
    end_ns: int


class _SpanLog:
    """The process's spans: totals of those closed with no profiler
    active, and the timeline of those opened under one (at most
    `cap` records; the rest are counted in `dropped`)."""

    def __init__(self):
        self.cap = _TIMELINE_CAP
        self.lock = threading.Lock()
        self.local = threading.local()
        self.totals: dict[str, list[int]] = {}   # count, total, first
        self.timeline: list[SpanRecord] = []
        self.dropped = 0

    def stack(self) -> list[str]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, name: str, ns: int) -> None:
        with self.lock:
            t = self.totals.get(name)
            if t is None:
                self.totals[name] = [1, ns, ns]
            else:
                t[0] += 1
                t[1] += ns

    def record(self, rec: SpanRecord) -> None:
        with self.lock:
            if len(self.timeline) < self.cap:
                self.timeline.append(rec)
            else:
                self.dropped += 1


_SPANS = _SpanLog()


class span:
    """`with span(name):` times a stretch of host work (the module
    docstring). With no profiler active it costs a flag check, two
    `perf_counter_ns` reads and a dict update."""

    __slots__ = ("name", "_t0", "_wall0", "_parent", "_fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._fn = None
        if _autograd_profiler._is_profiler_enabled:
            stack = _SPANS.stack()
            self._parent = stack[-1] if stack else None
            stack.append(self.name)
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
            # the stamps lie just inside the profiler's own event
            self._wall0 = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self._t0
        if self._fn is None:
            if not _autograd_profiler._is_profiler_enabled:
                _SPANS.add(self.name, ns)
            return
        wall1 = time.time_ns()
        self._fn.__exit__(*exc)
        _SPANS.stack().pop()
        _SPANS.record(SpanRecord(self.name, self._parent,
                                 threading.get_native_id(), self._wall0,
                                 wall1))


def span_totals() -> dict[str, SpanTotal]:
    """Per name: spans closed with no profiler active, their summed ns
    and the first one's ns (`perf_counter_ns`)."""
    with _SPANS.lock:
        return {k: SpanTotal(*v) for k, v in _SPANS.totals.items()}


def span_timeline() -> tuple[list[SpanRecord], int]:
    """The spans opened under a profiler, in the order they closed, and
    how many more the cap left out."""
    with _SPANS.lock:
        return list(_SPANS.timeline), _SPANS.dropped


def reset_spans() -> None:
    with _SPANS.lock:
        _SPANS.totals.clear()
        _SPANS.timeline.clear()
        _SPANS.dropped = 0


def trace_base_ns(ns: int) -> int:
    """The `baseTimeNanoseconds` of a Chrome trace exported by
    `torch.profiler` around the wall-clock stamp `ns`."""
    step = _TRACE_BASE_S * 1_000_000_000
    return ns // step * step


def trace_us(ns: int) -> float:
    """A `time.time_ns()` stamp as a Chrome trace `ts` (us)."""
    return (ns - trace_base_ns(ns)) / 1e3
