"""Structured metrics logging: jsonl stream + reference-style txt mirror.

This package's own copy of maskunet_tpu/core/metrics_log.py.

The reference appends free-text lines to per-script txt logs
(training_log_adek.txt etc., ade_semantic.py:389,427-429); this logger
keeps that human-readable mirror and adds a machine-parseable jsonl stream
(one object per step/epoch) plus step-time / images-per-second meters —
the observability layer the reference lacks (SURVEY.md §5).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    def __init__(self, directory: str, name: str = "train",
                 txt_mirror: bool = True):
        os.makedirs(directory, exist_ok=True)
        self.jsonl = open(os.path.join(directory, f"{name}_log.jsonl"), "a")
        self.txt = (open(os.path.join(directory, f"{name}_log.txt"), "a")
                    if txt_mirror else None)
        self._t0 = time.time()

    def log(self, record: dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        record["wall_s"] = round(time.time() - self._t0, 3)
        self.jsonl.write(json.dumps(record) + "\n")
        self.jsonl.flush()
        if self.txt is not None:
            parts = [f"{k}: {v}" for k, v in record.items()]
            self.txt.write(" ".join(parts) + "\n")
            self.txt.flush()

    def close(self) -> None:
        self.jsonl.close()
        if self.txt is not None:
            self.txt.close()


class Throughput:
    """images/sec meter with warmup skip (first step includes compile)."""

    def __init__(self):
        self.images = 0
        self.start: float | None = None

    def step(self, batch_size: int) -> None:
        if self.start is None:   # skip the compile step
            self.start = time.time()
            return
        self.images += batch_size

    def images_per_sec(self) -> float:
        if self.start is None or self.images == 0:
            return 0.0
        return self.images / (time.time() - self.start)
