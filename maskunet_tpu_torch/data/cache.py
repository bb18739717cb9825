"""In-RAM example cache: decode each example once, serve from memory after.

This package's own copy of maskunet_tpu/data/cache.py.

The training host has few cores while the decode path (JPEG + cv2 resize)
costs ~5-10 ms/image — on multi-epoch runs the input pipeline would bound
the TPU after the first epoch otherwise. The reference re-decodes every
epoch (its Dataset has no cache). At 128x128 an example is ~66 KB
(uint8 image + int32 masks), so even the 10k-image COCO subset is
~1.5 GB — comfortably RAM-resident.
"""

from __future__ import annotations

import threading


class CachedDataset:
    def __init__(self, dataset, max_examples: int | None = None):
        self.dataset = dataset
        self.max_examples = max_examples
        self._cache: dict[int, dict] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        ex = self.dataset[idx]
        if self.max_examples is None or len(self._cache) < self.max_examples:
            with self._lock:
                self._cache[idx] = ex
        return ex

    def __getattr__(self, name):
        return getattr(self.dataset, name)
