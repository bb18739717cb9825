"""Training-loop circuit breakers: early stopping and the overfit guard.

This package's own copy of maskunet_tpu/core/loop_control.py (a test holds
the two to the same decisions).

Reference semantics preserved exactly:
- EarlyStopping (ade_semantic.py:317-344): counter-based on training loss;
  improvement = strictly lower than best; saves a checkpoint on improvement;
  stops after `patience` consecutive non-improvements. Note the reference
  treats loss == best as improvement (only `>` increments the counter).
- Overfit guard (ade_semantic.py:420-422): stop when best_iou - avg_iou
  exceeds a margin (0.1).
"""

from __future__ import annotations

from typing import Callable


class EarlyStopping:
    def __init__(self, patience: int = 10, verbose: bool = False,
                 on_improve: Callable[[], None] | None = None):
        self.patience = patience
        self.verbose = verbose
        self.on_improve = on_improve
        self.counter = 0
        self.best_score: float | None = None
        self.early_stop = False

    def __call__(self, loss: float) -> bool:
        if self.best_score is None or loss <= self.best_score:
            self.best_score = loss if self.best_score is None else min(
                self.best_score, loss)
            self.counter = 0
            if self.on_improve:
                self.on_improve()
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


class OverfitGuard:
    def __init__(self, margin: float = 0.1):
        self.margin = margin
        self.best_iou = 0.0

    def __call__(self, avg_iou: float) -> bool:
        self.best_iou = max(self.best_iou, avg_iou)
        return (self.best_iou - avg_iou) > self.margin
