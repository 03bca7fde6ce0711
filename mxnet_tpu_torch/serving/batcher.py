"""Dynamic batching + the shape-bucket lattice (counterpart of
``mxnet_tpu/serving/batcher.py``).

:class:`BucketLattice` pads every batch up to a fixed (batch, seq)
lattice point, so the engine runs a bounded set of shapes.
:class:`DynamicBatcher` is the bounded admission queue in front of the
scheduler, one FIFO per priority class: batches form highest class
first and close at ``max_batch`` compatible requests or when the oldest
has waited ``max_wait_us``.  At depth an arrival evicts the youngest
queued request of the lowest class strictly below its own (``put``
returns it; the engine fails its future typed), never a preempted
continuation (its progress is parked, the most expensive queued work);
with nothing to evict the arrival sheds with
:class:`~.errors.QueueFullError`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

from ..analysis.lockwitness import named_condition as _named_condition
from .errors import EngineStoppedError, QueueFullError, ServingError
from .overload import PRIORITIES, PRIORITY_BATCH

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

    def __len__(self):
        return len(self.batch_buckets) * len(self.seq_buckets)

    def __repr__(self):
        return (f"BucketLattice(batch={self.batch_buckets}, "
                f"seq={self.seq_buckets})")


def _ordinal(req) -> int:
    # requests without a priority attribute (direct DynamicBatcher
    # users, tests) ride the default middle class
    return getattr(req, "priority", PRIORITY_BATCH)


class DynamicBatcher:
    """Bounded, priority-aware admission queue with max-batch/max-wait
    batch forming (see the module docstring for the shed/evict
    contract).

    The engine and the batcher share one Condition: producers
    (``put``) notify the scheduler thread; the scheduler blocks in
    ``get_batch`` only when it has nothing else to do (idle engine) and
    otherwise drains whatever is ready without waiting (continuous
    batching never stalls running requests on arriving ones).
    """

    def __init__(self, max_depth: int = 64,
                 cond: Optional[threading.Condition] = None):
        self.max_depth = max_depth
        self._cond = cond or _named_condition(
            "serving.batcher.cond", "standalone-batcher admission queue")
        # one FIFO per priority class, highest (ordinal 0) first
        self._qs: Tuple[deque, ...] = tuple(
            deque() for _ in PRIORITIES)
        self._n = 0
        self._closed = False
        # deepest the queue has ever been (exported as the
        # mxtpu_serving_queue_depth_highwater gauge): the capacity-
        # planning number — how close admission came to shedding
        self.depth_highwater = 0

    @property
    def cond(self) -> threading.Condition:
        return self._cond

    def __len__(self):
        # an atomic int read: probes must not contend with admission
        return self._n

    def empty(self) -> bool:
        # the scheduler re-checks under the shared cond before waiting
        return self._n == 0

    def depth_at_or_above(self, ordinal: int) -> int:
        """Queued requests at class ``ordinal`` or higher — the queue a
        new request of that class actually waits behind (deadline-
        admission's wait estimate; lower classes never delay it)."""
        with self._cond:
            return sum(len(q) for q in self._qs[:ordinal + 1])

    def waiting_at_or_above(self, ordinal: int, now: float) -> int:
        """Like :meth:`depth_at_or_above`, but counting only requests
        whose deadline has not already passed — the arrivals preemption
        would actually serve (an expired request fails at its next
        admission; evicting a healthy victim for it is pure churn)."""
        with self._cond:
            return sum(1 for q in self._qs[:ordinal + 1] for r in q
                       if not r.expired(now))

    def put(self, req):
        """Enqueue, evict-and-enqueue, or shed.  Never blocks the
        caller; O(1) below depth — only the at-depth eviction scan is
        O(depth), and only while overloaded.  Returns the EVICTED
        victim request (priority shed — the caller owns failing its
        future typed) or ``None``; raises :class:`QueueFullError` when
        the queue is at depth and no strictly-lower-class request is
        queued."""
        with self._cond:
            if self._closed:
                raise EngineStoppedError(
                    "engine is stopped — request not accepted")
            victim = None
            if self._n >= self.max_depth:
                pr = _ordinal(req)
                # evict the YOUNGEST non-preempted request of the
                # LOWEST class strictly below the arrival — the
                # cheapest queued work.  A preempted continuation is
                # the most expensive item in the queue (its progress is
                # parked in the prefix pool awaiting resume), so it is
                # never the cheapest to shed.
                for lvl in range(len(self._qs) - 1, pr, -1):
                    q = self._qs[lvl]
                    for r in reversed(q):
                        if not getattr(r, "preempted", 0):
                            q.remove(r)
                            victim = r
                            self._n -= 1
                            break
                    if victim is not None:
                        break
                if victim is None:
                    raise QueueFullError(
                        f"request queue at configured depth "
                        f"{self.max_depth} — shedding load")
            req.t_enqueue = time.monotonic()
            self._qs[_ordinal(req)].append(req)
            self._n += 1
            if self._n > self.depth_highwater:
                self.depth_highwater = self._n
            self._cond.notify_all()
            return victim

    def requeue(self, req) -> None:
        """Put a PREEMPTED request back at the FRONT of its class so it
        resumes as soon as capacity returns.  Exempt from the depth
        bound (bounded by num_slots concurrent preemptions) — a parked
        victim must never be lost to queue-full — and from the closed
        check only insofar as a closed queue fails it at drain like any
        other queued request."""
        with self._cond:
            if self._closed:
                raise EngineStoppedError(
                    "engine is stopped — request not accepted")
            self._qs[_ordinal(req)].appendleft(req)
            self._n += 1
            if self._n > self.depth_highwater:
                self.depth_highwater = self._n
            self._cond.notify_all()

    def remove(self, fut):
        """Remove and return the queued request whose future is ``fut``
        (the hedged-loser cancellation path), or ``None``."""
        with self._cond:
            for q in self._qs:
                for r in q:
                    if r.future is fut:
                        q.remove(r)
                        self._n -= 1
                        return r
        return None

    def _head(self):
        for q in self._qs:
            if q:
                return q[0]
        return None

    def get_batch(self, max_batch: int, max_wait_us: float,
                  compatible: Optional[Callable] = None,
                  wait: bool = True) -> List:
        """Form one batch, highest priority class first.

        Blocks (if ``wait``) until at least one request is queued, then
        keeps collecting until ``max_batch`` COMPATIBLE requests are
        ready or the oldest (highest-class) has waited ``max_wait_us``.
        ``compatible`` maps a request to a grouping key (e.g. input
        shape); the batch takes the head's key and skips over
        mismatches without reordering them.  Returns [] if
        closed-and-empty or ``wait`` is False with nothing queued.
        """
        with self._cond:
            if wait:
                while self._n == 0 and not self._closed:
                    self._cond.wait(0.1)
            if self._n == 0:
                return []
            head = self._head()
            deadline = head.t_enqueue + max_wait_us * 1e-6
            while self._n < max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            head = self._head()          # may have been evicted/removed
            if head is None:
                return []
            key = compatible(head) if compatible else None
            batch: List = []
            for q in self._qs:
                if len(batch) >= max_batch:
                    break
                leftover = deque()
                while q and len(batch) < max_batch:
                    r = q.popleft()
                    if compatible is None or compatible(r) == key:
                        batch.append(r)
                    else:
                        leftover.append(r)
                leftover.extend(q)
                q.clear()
                q.extend(leftover)
            self._n -= len(batch)
            return batch

    def drain(self) -> List:
        """Remove and return everything queued (shutdown/cancel path),
        highest class first."""
        with self._cond:
            out: List = []
            for q in self._qs:
                out.extend(q)
                q.clear()
            self._n = 0
            return out

    def close(self):
        """Stop accepting new requests; wake any waiter."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        # close is one-way: a stale False only delays one probe
        return self._closed
