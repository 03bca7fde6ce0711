"""Dynamic batching + the shape-bucket lattice (counterpart of
``mxnet_tpu/serving/batcher.py``, without priority classes).

:class:`BucketLattice` pads every batch up to a fixed (batch, seq)
lattice point, so the engine runs a bounded set of shapes.
:class:`DynamicBatcher` is the bounded admission queue in front of the
scheduler: overflow is shed at ``put`` (backpressure, not backlog), and
a batch closes at ``max_batch`` requests or when the oldest has waited
``max_wait_us``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

from ..analysis.lockwitness import named_condition as _named_condition
from .errors import EngineStoppedError, QueueFullError, ServingError

__all__ = ["BucketLattice", "DynamicBatcher"]


def _pow2_lattice(lo: int, hi: int) -> Tuple[int, ...]:
    out, v = [], lo
    while v < hi:
        out.append(v)
        v *= 2
    out.append(hi)
    return tuple(out)


class BucketLattice:
    """The (batch, seq) padding lattice; ``batch(n)``/``seq(t)`` round up
    to the nearest point.  Defaults: powers of two."""

    def __init__(self, batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 8, max_seq: int = 1024):
        bb = tuple(sorted(set(batch_buckets))) if batch_buckets else \
            _pow2_lattice(1, max_batch)
        sb = tuple(sorted(set(seq_buckets))) if seq_buckets else \
            _pow2_lattice(min(16, max_seq), max_seq)
        if bb[0] < 1 or sb[0] < 1:
            raise ServingError(f"buckets must be >= 1, got {bb} / {sb}")
        self.batch_buckets = bb
        self.seq_buckets = sb

    @staticmethod
    def _round_up(v: int, buckets: Tuple[int, ...]) -> int:
        for b in buckets:
            if v <= b:
                return b
        raise ServingError(f"{v} exceeds largest bucket {buckets[-1]}")

    def batch(self, n: int) -> int:
        return self._round_up(n, self.batch_buckets)

    def seq(self, t: int) -> int:
        return self._round_up(t, self.seq_buckets)

    @property
    def max_seq(self) -> int:
        return self.seq_buckets[-1]

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def prefill_points(self, max_seq: Optional[int] = None):
        """Every (batch_bucket, seq_bucket) pair — the warmup set.
        ``max_seq`` caps the seq side at its bucket (no prefill call runs
        more than the engine's ``prefill_chunk`` tokens)."""
        sb = self.seq_buckets if max_seq is None else \
            tuple(s for s in self.seq_buckets if s <= self.seq(max_seq))
        return [(b, s) for b in self.batch_buckets for s in sb]


class DynamicBatcher:
    """Bounded FIFO admission queue with max-batch/max-wait batch
    forming.  The engine and the batcher share one Condition: ``put``
    notifies the scheduler thread."""

    def __init__(self, max_depth: int = 64,
                 cond: Optional[threading.Condition] = None):
        self.max_depth = max_depth
        self._cond = cond or _named_condition(
            "serving.batcher.cond", "standalone-batcher admission queue")
        self._q: deque = deque()
        self._closed = False

    def __len__(self):
        return len(self._q)

    def empty(self) -> bool:
        return not self._q

    def put(self, req):
        """Enqueue, or shed with :class:`QueueFullError` at depth."""
        with self._cond:
            if self._closed:
                raise EngineStoppedError(
                    "engine is stopped — request not accepted")
            if len(self._q) >= self.max_depth:
                raise QueueFullError(f"request queue at configured depth "
                                     f"{self.max_depth} — shedding load")
            req.t_enqueue = time.monotonic()
            self._q.append(req)
            self._cond.notify_all()

    def requeue(self, req):
        """Put an accepted request back at the FRONT (admission blocked on
        pages); exempt from the depth bound and from ``close`` so that a
        draining engine still finishes it."""
        with self._cond:
            self._q.appendleft(req)
            self._cond.notify_all()

    def get_batch(self, max_batch: int, max_wait_us: float,
                  compatible: Optional[Callable] = None) -> List:
        """Form one batch without blocking on an empty queue: collect
        until ``max_batch`` requests are ready or the oldest has waited
        ``max_wait_us``.  ``compatible`` maps a request to a grouping
        key (the forward mode's input shape): the batch takes the
        head's key and skips over other keys without reordering them.
        [] if nothing is queued."""
        with self._cond:
            if not self._q:
                return []
            deadline = self._q[0].t_enqueue + max_wait_us * 1e-6
            while len(self._q) < max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            key = compatible(self._q[0]) if compatible else None
            batch, leftover = [], deque()
            while self._q and len(batch) < max_batch:
                r = self._q.popleft()
                if compatible is None or compatible(r) == key:
                    batch.append(r)
                else:
                    leftover.append(r)
            self._q.extendleft(reversed(leftover))
            return batch

    def drain(self) -> List:
        """Remove and return everything queued."""
        with self._cond:
            out = list(self._q)
            self._q.clear()
            return out

    def close(self):
        """Stop accepting new requests; wake any waiter."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
