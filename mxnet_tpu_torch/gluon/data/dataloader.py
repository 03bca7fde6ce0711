"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``;
MXNet's ``python/mxnet/gluon/data/dataloader.py``).

Workers are threads, not forked processes: a process that has touched
CUDA cannot fork safely (MXNet needed engine fork-handlers for its
process workers).  Decode and augment are numpy, which releases the GIL
in its loops.  Batches live on the host, as NDArrays on ``mx.cpu()``;
``pin_memory=True`` makes them page-locked when a card is present, so
:class:`mxnet_tpu_torch.data.DevicePrefetcher` copies them to the card
asynchronously without a staging copy.
"""
from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as onp
import torch

from ...context import cpu as _cpu
from ...ndarray import NDArray, array
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (parity: default_batchify_fn); the
    batch is an NDArray on ``mx.cpu()``."""
    if isinstance(data[0], NDArray):
        return array(onp.stack([d.asnumpy() for d in data]), ctx=_cpu())
    if isinstance(data[0], tuple):
        transposed = zip(*data)
        return tuple(default_batchify_fn(list(x)) for x in transposed)
    arr = onp.asarray(data)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return array(arr, ctx=_cpu())


def _pin(batch):
    """``batch`` with every host NDArray moved into page-locked memory."""
    if isinstance(batch, NDArray):
        t = batch.tensor
        return batch if t.device.type != "cpu" or t.is_pinned() else \
            NDArray(t.pin_memory())
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pin(b) for b in batch)
    return batch


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler: Optional[Sampler] = None, last_batch=None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_pool=False, timeout=120):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                        last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * num_workers)
        # page-locking needs a card to lock the memory for
        self._pin_memory = bool(pin_memory) and torch.cuda.is_available()
        self._timeout = timeout

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices):
        batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pin(batch) if self._pin_memory else batch

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return
        # threaded prefetch pipeline
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = queue.Queue()
            batches = iter(self._batch_sampler)

            def submit_next():
                try:
                    idx = next(batches)
                except StopIteration:
                    return False
                futures.put(pool.submit(self._load_batch, idx))
                return True

            for _ in range(self._prefetch or self._num_workers * 2):
                if not submit_next():
                    break
            while not futures.empty():
                fut = futures.get()
                submit_next()
                yield fut.result(timeout=self._timeout)
