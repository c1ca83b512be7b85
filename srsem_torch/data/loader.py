"""Batching and threaded prefetch — a copy of srsem/data/loader.py.

Replaces the reference's ``DataLoader(num_workers=8, pin_memory=True)``
(reference: CLIPLPIPS_REG_training_sweep_example.py:159-188): decode and
preprocess run in a thread pool (PIL releases the GIL around decode and
resize); batches are collated to numpy and prefetched through a bounded
queue so host work overlaps the card's.  The final partial batch is padded
to the batch size by repeating its last row, with a validity mask, so every
train step sees one shape.  Batches stay numpy; the training loop copies
them to the card (srsem_torch/train/loop.py).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def collate(samples) -> tuple:
    """zip/stack pair collation: [((a, b), y), ...] → ((A, B), Y)."""
    pairs, labels = zip(*samples)
    imgs_a = np.stack([p[0] for p in pairs])
    imgs_b = np.stack([p[1] for p in pairs])
    return (imgs_a, imgs_b), np.stack(labels)


def pad_batch(batch, batch_size: int):
    """Pad a collated batch to ``batch_size`` rows by repeating its last
    row; returns (batch, mask) with mask 1 on the real rows."""
    (a, b), y = batch
    n = a.shape[0]
    mask = np.zeros((batch_size,), np.float32)
    mask[:n] = 1.0
    if n < batch_size:
        pad = lambda x: np.concatenate(  # noqa: E731
            [x, np.repeat(x[-1:], batch_size - n, axis=0)], axis=0)
        a, b, y = pad(a), pad(b), pad(y)
    return ((a, b), y), mask


def peek_first_batch(loader):
    """First (masked) batch for shape probes, WITHOUT consuming a
    :class:`Loader` epoch (see :meth:`Loader.peek_batch`); plain iterables
    fall back to ``next(iter(...))``."""
    if hasattr(loader, "peek_batch"):
        return loader.peek_batch()
    return next(iter(loader))


class Loader:
    """Iterable over padded, masked batches with background prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def peek_batch(self):
        """One collated and padded batch for shape probes.  It does not
        advance the epoch counter: ``__iter__`` seeds epoch ``e``'s shuffle
        with ``seed + e``, and a consuming peek would start training on the
        seed + 1 ordering."""
        idxs = range(min(self.batch_size, len(self.dataset)))
        samples = [self.dataset[int(i)] for i in idxs]
        return pad_batch(collate(samples), self.batch_size)

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        batches = [
            order[i: i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # A bounded put that notices the consumer leaving early.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # A dataset error must reach the consumer, never hang it.
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(self.dataset.__getitem__, idxs))
                        if not put(pad_batch(collate(samples),
                                             self.batch_size)):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
