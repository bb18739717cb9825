"""The card's SM clock, power draw, temperature and clock-event reasons
while the window runs, read through NVML (`libnvidia-ml.so.1`, by ctypes)
on a thread that samples every `every_s` seconds. Printed beside each
run's numbers, so that a run that reads far off can be told apart by its
clocks; nothing here is a metric. Where NVML cannot be loaded the summary
says so and the run goes on.
"""

from __future__ import annotations

import ctypes
import statistics
import threading

_CLOCK_SM = 1
_TEMP_GPU = 0


class Sampler:
    def __init__(self, index: int = 0, every_s: float = 0.5):
        self.every_s = every_s
        self.samples: list[tuple[int, float, int, int]] = []
        self.error = None
        self._stop = threading.Event()
        self._thread = None
        try:
            self._nvml = ctypes.CDLL("libnvidia-ml.so.1")
            self._check(self._nvml.nvmlInit_v2())
            self._handle = ctypes.c_void_p()
            self._check(self._nvml.nvmlDeviceGetHandleByIndex_v2(
                index, ctypes.byref(self._handle)))
            self._reasons = getattr(
                self._nvml, "nvmlDeviceGetCurrentClocksEventReasons", None) \
                or self._nvml.nvmlDeviceGetCurrentClocksThrottleReasons
        except (OSError, AttributeError, RuntimeError) as e:
            self.error = str(e)

    @staticmethod
    def _check(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"NVML error {rc}")

    def _sample(self) -> None:
        clock, power, temp = (ctypes.c_uint(), ctypes.c_uint(),
                              ctypes.c_uint())
        reasons = ctypes.c_ulonglong()
        self._check(self._nvml.nvmlDeviceGetClockInfo(
            self._handle, _CLOCK_SM, ctypes.byref(clock)))
        self._check(self._nvml.nvmlDeviceGetPowerUsage(
            self._handle, ctypes.byref(power)))
        self._check(self._nvml.nvmlDeviceGetTemperature(
            self._handle, _TEMP_GPU, ctypes.byref(temp)))
        self._check(self._reasons(self._handle, ctypes.byref(reasons)))
        self.samples.append((clock.value, power.value / 1000.0, temp.value,
                             reasons.value))

    def _loop(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self._sample()
            except RuntimeError as e:
                self.error = str(e)
                return

    def start(self) -> None:
        if self.error is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> dict:
        """{'sm_mhz', 'power_w', 'temp_c': [min, median, max],
        'clock_event_reasons': the union of the reason bits, 'samples'}."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        if self.error is not None or not self.samples:
            return {"nvml": self.error or "no sample"}
        out = {}
        for i, key in enumerate(("sm_mhz", "power_w", "temp_c")):
            vals = [s[i] for s in self.samples]
            out[key] = [min(vals), statistics.median(vals), max(vals)]
        reasons = 0
        for s in self.samples:
            reasons |= s[3]
        out["clock_event_reasons"] = hex(reasons)
        out["samples"] = len(self.samples)
        return out
