"""Threaded prefetching data loader: decode-ahead + device-copy overlap.

Counterpart of ``rtfs_tpu/data/loader.py`` (reference ``DataLoader(
num_workers=8, pin_memory=True)``, ``train.py:44-52``):

- a thread pool decodes samples (scipy's WAV read and ``np.load`` spend
  most of their time outside the GIL);
- a producer thread assembles numpy batches into a bounded queue, keeping
  ``lookahead`` batches of per-sample decodes in flight;
- the consuming generator calls ``place`` one batch AHEAD of yielding, so
  the host-to-device copy of batch N+1 is queued while the caller still
  works on batch N (``pin_and_copy``: pinned host tensors, then a
  ``non_blocking`` copy on the caller's current stream, which orders it
  before any kernel that stream runs later).

Augmentation randomness is per-sample seeded (``dataset.sample_rng``), so
an epoch's batches equal the synchronous ``dataset.batches`` path bit for
bit whatever the thread scheduling.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


class PrefetchLoader:
    """Asynchronous batch iterator over an ``AVSpeechDataset``-like dataset.

    Datasets must expose ``batch_index_plan``, ``sample_rng``, ``collate``,
    and indexed ``__getitem__``; anything else (e.g. ``SyntheticAVDataset``)
    falls back to its synchronous ``batches()``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: Optional[int] = None,
        lookahead: int = 3,
        place: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers or min(8, os.cpu_count() or 4)
        self.lookahead = max(1, lookahead)
        self.place = place
        self._threaded = all(
            hasattr(dataset, a)
            for a in ("batch_index_plan", "sample_rng", "collate")
        )

    def epoch(self, **plan_kwargs) -> Iterator[dict]:
        if not self._threaded:
            yield from self._passthrough(**plan_kwargs)
            return

        seed = plan_kwargs.get("seed", 0)
        ep = plan_kwargs.get("epoch", 0)
        plan = self.dataset.batch_index_plan(self.batch_size, **plan_kwargs)
        if not plan:
            return

        q: queue.Queue = queue.Queue(maxsize=self.lookahead)
        stop = threading.Event()
        _END = object()

        def decode(idx):
            return self.dataset.__getitem__(
                int(idx), self.dataset.sample_rng(idx, seed, ep)
            )

        def produce(pool):
            try:
                pending = deque()
                it = iter(plan)
                while True:
                    while len(pending) <= self.lookahead:
                        idxs = next(it, None)
                        if idxs is None:
                            break
                        pending.append([pool.submit(decode, i) for i in idxs])
                    if not pending:
                        break
                    items = [f.result() for f in pending.popleft()]
                    batch = self.dataset.collate(items)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            pass
                    if stop.is_set():
                        return
                q.put(_END)
            except BaseException as e:  # surfaced in the consumer
                q.put(e)

        pool = ThreadPoolExecutor(self.num_workers)
        producer = threading.Thread(target=produce, args=(pool,), daemon=True)
        producer.start()
        staged = None  # the already-placed (copying) batch
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                placed = self._place(item)
                if staged is not None:
                    yield staged
                staged = placed
            if staged is not None:
                yield staged
        finally:
            stop.set()
            # unblock a producer waiting on a full queue
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            producer.join(timeout=5.0)
            pool.shutdown(wait=False, cancel_futures=True)

    def _place(self, batch: dict) -> dict:
        """Apply ``place`` to the array fields, carrying ``key`` through."""
        if self.place is None:
            return batch
        key = batch.pop("key", None)
        placed = self.place(batch)
        if key is not None:
            placed = {**placed, "key": key}
        return placed

    def _passthrough(self, **plan_kwargs) -> Iterator[dict]:
        for batch in self.dataset.batches(self.batch_size, **plan_kwargs):
            yield self._place(batch)


def pin_and_copy(device) -> Callable[[dict], dict]:
    """The ``place`` function of a training loop on ``device``.

    On a CUDA device: each array field goes into a pinned host tensor, then
    to the device with ``non_blocking=True`` on the current stream (the
    caller's), so the copy is ordered before the step that reads it without
    a host synchronisation; the caching host allocator keeps the pinned
    buffer until the copy has run. On the CPU: ``torch.as_tensor``.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: {k: torch.as_tensor(v) for k, v in batch.items()}

    def place(batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(device, non_blocking=True) for k, v in batch.items()}

    return place


class WaitTimer:
    """Iterates ``batches``, summing in ``wait`` the seconds the caller
    spent blocked in ``next``: over a loop's wall time, the loader's wait
    share. ``first`` is the wait for the first batch, which no earlier
    step hides."""

    def __init__(self, batches: Iterable):
        self._it = iter(batches)
        self.wait = 0.0
        self.first = 0.0
        self.count = 0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            batch = next(self._it)
        finally:
            waited = time.perf_counter() - t0
            self.wait += waited
        if not self.count:
            self.first = waited
        self.count += 1
        return batch
