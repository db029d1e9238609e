"""Numpy batch loader.

Counterpart of ``adaptpoint_tpu/datasets/loader.py``. Per-sample transforms
run in numpy on the host; each sample draws from its own generator
``default_rng((seed, epoch, index))`` and the order from
``default_rng((seed, epoch))``, so the batches do not depend on the number
of worker threads and equal the JAX package's bit for bit. With
``drop_last=False`` a short last batch is padded to full size and
``n_valid`` says how many of its rows are real.
"""
from __future__ import annotations

import collections
import concurrent.futures as futures
from typing import Dict, Iterator

import numpy as np

__all__ = ["NumpyLoader"]


class NumpyLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, order, b: int, epoch: int) -> Dict[str, np.ndarray]:
        # the epoch is the one __iter__ started with, so a batch assembled
        # ahead by a worker keeps that epoch's draws
        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
        n_valid = len(idxs)
        if n_valid < self.batch_size:
            idxs = np.concatenate(
                [idxs, np.resize(idxs, self.batch_size - n_valid)])
        samples = [self.dataset.get(int(i), np.random.default_rng(
            (self.seed, epoch, int(i)))) for i in idxs]
        batch = {key: np.stack([np.asarray(s[key]) for s in samples])
                 for key in samples[0]}
        batch["n_valid"] = np.asarray(n_valid, np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        nb = len(self)
        if self.num_workers <= 0:
            for b in range(nb):
                yield self._make_batch(order, b, epoch)
            return
        # a thread pool assembles whole batches ahead of the consumer
        pool = futures.ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            depth = max(2, self.num_workers)
            pending = collections.deque(
                pool.submit(self._make_batch, order, b, epoch)
                for b in range(min(depth, nb)))
            nxt = len(pending)
            while pending:
                batch = pending.popleft().result()
                if nxt < nb:
                    pending.append(pool.submit(self._make_batch, order, nxt,
                                               epoch))
                    nxt += 1
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
