"""Host-staged input pipeline: decode -> batch -> prefetch -> device.

Counterpart of maskunet_tpu/data/pipeline.py. `BatchIterator` is its own
copy of the JAX one (the same order, padding and `valid` for a seed and
epoch):

- datasets are plain objects with `__len__` and `__getitem__(i) -> dict of
  numpy arrays`;
- a thread pool decodes ahead of the training step;
- batches travel to the card as uint8 and become f32/255 there (ToTensor
  semantics, 4x less host-to-device traffic);
- a prefetcher overlaps host decode and the copies with the card's work.

Batching is static-shape: training drops the final partial batch (the
cached attention masks are sized for the batch); evaluation pads the final
batch and reports a `valid` mask.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Iterator, Protocol

import numpy as np
import torch

from maskunet_tpu_torch.utils.profiling import span


class Dataset(Protocol):
    def __len__(self) -> int: ...
    def __getitem__(self, idx: int) -> dict[str, np.ndarray]: ...


def _stack(examples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples]) for k in keys}


class BatchIterator:
    """Seeded, shuffled, thread-decoded batch iterator over one epoch."""

    def __init__(self, dataset: Dataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 pad_last: bool = False, num_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_threads = num_threads

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last and not self.pad_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        bs = self.batch_size
        with concurrent.futures.ThreadPoolExecutor(self.num_threads) as pool:
            # pipeline two batches ahead
            pending: list[list[concurrent.futures.Future]] = []
            starts = list(range(0, len(order), bs))
            for start in starts:
                idxs = order[start:start + bs]
                if len(idxs) < bs:
                    if self.drop_last and not self.pad_last:
                        continue
                pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                for i in idxs])
                while len(pending) > 2:
                    yield self._finish(pending.pop(0))
            while pending:
                yield self._finish(pending.pop(0))

    def _finish(self, futures) -> dict[str, np.ndarray]:
        examples = [f.result() for f in futures]
        batch = _stack(examples)
        n = len(examples)
        if self.pad_last and n < self.batch_size:
            pad = self.batch_size - n
            batch = {k: np.concatenate(
                [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in batch.items()}
        batch["valid"] = np.arange(self.batch_size if self.pad_last
                                   else n) < n
        return batch


def to_device(batch: dict[str, np.ndarray], device: str | torch.device
              ) -> dict[str, torch.Tensor]:
    """Move a host batch to `device`; a uint8 image becomes f32/255 there,
    every other array keeps its dtype.

    To a card, each array is staged in pinned host memory and copied with
    `non_blocking=True` on the current stream. Then the stream is
    synchronised, so the pinned buffers can go when this returns: call it
    from a thread that may wait (the `Prefetcher`'s)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device, copy=True)
        if k == "image" and t.dtype == torch.uint8:
            t = t.float() / 255.0
        out[k] = t
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out


class Prefetcher:
    """Background thread that keeps `depth` device-resident batches ready.

    On a card the thread issues its copies on a stream of its own, so they
    overlap the train step on the consumer's stream, and it waits for each
    batch's copies before queueing it (the pinned host buffers live until
    then). The consumer records every tensor it takes on its current
    stream, so the allocator does not hand the prefetch stream that memory
    again while the consumer's kernels still read it. The consumer's wait
    on the queue is the span `feed.wait` (`utils.profiling.span`).

    Use as a context manager (or call `close()`): a consumer that stops
    early (break / max_batches) would otherwise leave the worker blocked
    on a full queue forever, leaking the thread, the decode pool of the
    underlying generator, and device-resident batches.
    """

    def __init__(self, iterator: Iterator[dict[str, np.ndarray]], *,
                 device: str | torch.device = "cuda", depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iterator,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up once close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch):
        if self._stream is None:
            return to_device(batch, self._device)
        with torch.cuda.stream(self._stream):
            return to_device(batch, self._device)

    def _worker(self, iterator):
        try:
            try:
                for batch in iterator:
                    if not self._put(self._to_device(batch)):
                        return
            finally:
                # release the generator's resources (e.g. the decode
                # thread pool inside BatchIterator.epoch) promptly
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            self._put(e)
            return
        self._put(None)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        with span("feed.wait"):
            item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        if self._stream is not None:
            consumer = torch.cuda.current_stream(self._device)
            for t in item.values():
                t.record_stream(consumer)
        return item
