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
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Callable, Iterator

import torch


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
