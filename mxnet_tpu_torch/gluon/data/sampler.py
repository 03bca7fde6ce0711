"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``;
MXNet's ``python/mxnet/gluon/data/sampler.py``).  Shuffles draw from
numpy: the global ``numpy.random`` state, or ``mx.random.host_rng()``,
which ``mx.random.seed`` reseeds, so the same seeds give the JAX
package's orders bit for bit."""
from __future__ import annotations

import numpy as onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(onp.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"last_batch must be keep/discard/rollover, "
                                 f"got {self._last_batch}")

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class FixedBucketSampler(Sampler):
    """Batch sampler assigning variable-length samples to fixed-length
    buckets (the Sockeye/GluonNLP bucketing mechanism — upstream it lived
    in gluonnlp.data; in-tree here because a bucket is one compiled
    signature: a CUDA graph per batch shape).

    Parameters
    ----------
    lengths : list of int (or list of tuple for multi-input)
    batch_size : samples per batch
    num_buckets : bucket count; edges are linear between min and max length
    shuffle : shuffle batches (and samples within buckets) each epoch
    """

    def __init__(self, lengths, batch_size, num_buckets=10, shuffle=False,
                 bucket_keys=None, seed=None):
        import numpy as onp

        self._lengths = [max(l) if isinstance(l, (tuple, list)) else l
                         for l in lengths]
        self._batch_size = batch_size
        self._shuffle = shuffle
        lo, hi = min(self._lengths), max(self._lengths)
        explicit = bucket_keys is not None
        if bucket_keys is None:
            num_buckets = max(1, min(num_buckets, hi - lo + 1))
            bucket_keys = set(
                int(round(lo + (hi - lo) * (i + 1) / num_buckets))
                for i in range(num_buckets))
        self.bucket_keys = sorted(bucket_keys)
        buckets = {k: [] for k in self.bucket_keys}
        for i, l in enumerate(self._lengths):
            for k in self.bucket_keys:
                if l <= k:
                    buckets[k].append(i)
                    break
            else:
                if explicit:
                    raise ValueError(
                        f"sample {i} has length {l} > largest bucket key "
                        f"{self.bucket_keys[-1]} — downstream pad-to-key "
                        "code would truncate it")
                buckets[self.bucket_keys[-1]].append(i)
        self._buckets = buckets
        # seed=None follows the global mx.random state (upstream gluonnlp
        # draws from the global RNG); an explicit seed pins the order.
        # The global rng is looked up PER ITERATION (not cached) so a
        # later mx.random.seed() still governs epoch orders.
        self._rng = onp.random.RandomState(int(seed)) \
            if seed is not None else None

    def __iter__(self):
        if self._rng is not None:
            rng = self._rng
        else:
            from ... import random as _random
            rng = _random.host_rng()
        batches = []
        for k in self.bucket_keys:
            idx = list(self._buckets[k])
            if self._shuffle:
                rng.shuffle(idx)
            for i in range(0, len(idx), self._batch_size):
                batches.append(idx[i:i + self._batch_size])
        if self._shuffle:
            rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        return sum(-(-len(v) // self._batch_size)
                   for v in self._buckets.values())

    def stats(self):
        """Human-readable bucket occupancy (gluonnlp parity)."""
        return {k: len(v) for k, v in self._buckets.items()}
