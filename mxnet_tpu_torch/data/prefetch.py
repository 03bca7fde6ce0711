"""Double-buffered device prefetch: ship batch N+1 while step N runs.

Counterpart of ``mxnet_tpu/data/prefetch.py``.  ``DevicePrefetcher``
wraps any batch source — a DataIter (``io.PrefetchingIter``,
``NDArrayIter``, ``ImageRecordIter``), a ``gluon.data.DataLoader``, a
``ShardedLoader``, or a plain iterator of ``(data, labels)`` pairs — and
keeps a bounded ring of batches already on the card.

On the card (where the reference calls ``jax.device_put`` on a feeder
thread) a feeder thread copies each batch on its own CUDA stream:

- host arrays that are not page-locked are first copied into
  page-locked blocks of the caching host allocator (``pin_memory()``,
  whose block is reused only after the copy that read it has finished);
  page-locked arrays (a ``DataLoader(pin_memory=True)``'s) are copied
  from directly;
- the copy to the card is ``non_blocking`` on the feeder's stream, into
  memory the caching allocator gives that stream, followed by the
  ``transform=`` hook (:class:`~mxnet_tpu_torch.data.transforms.
  DeviceTransform`) on the same stream, and an event recorded per batch;
- :meth:`next` makes the caller's current stream wait on that event (a
  wait on the card, never ``torch.cuda.synchronize()``) and marks each
  tensor as used by that stream (``record_stream``), so its memory is
  reused only after the caller's stream has passed the step that read it.
  A replaying graph therefore never reads a batch the feeder overwrote.

On the CPU the same ring runs without streams: batches are handed over
as CPU NDArrays.

Concurrency contract: the ring is guarded by the witnessed condition
``data.prefetch``.  The feeder is the only reader of ``source`` while it
is alive; on feeder death the consumer takes ownership and degrades to
synchronous pulls at the correct offset, so a killed feeder mid-epoch
loses no batch and the delivered sequence stays bit-identical.

Fault sites:

- ``data.prefetch`` — top of each feed cycle, before the source is
  touched (a kill here leaves the source position clean).  An injected
  fault degrades that one batch to a synchronous hand-off of the host
  arrays (the trainer copies them), counted, never lost.
- ``data.device_put`` — around the copy to the card; retried once, then
  the batch falls back to host arrays (the trainer pays the copy for
  that step instead).

Resume: ``state_dict()``/``load_state_dict()`` carry the consumed-batch
offset so a restored pipeline fast-forwards its source and replays the
exact remaining sequence (``ResilientLoop``'s replay contract).
"""
from __future__ import annotations

import atexit
import threading
import time
import weakref
from collections import deque
from typing import Callable, Optional

import numpy as onp
import torch

from .. import base as _base
from ..analysis.lockwitness import named_condition as _named_condition
from .. import context as _context
from ..context import Context, resolve_device
from ..io import DataBatch
from ..ndarray import NDArray
from ..observability.flightrecorder import active as _fr_active
from ..observability.registry import default_registry as _registry
from ..resilience.faults import inject as _inject

__all__ = ["DevicePrefetcher", "DataPipelineError"]


class DataPipelineError(_base.MXNetError):
    """Typed failure from the mxnet_tpu_torch.data subsystem."""


_END = object()          # source exhausted (clean end of epoch)

# every prefetcher whose feeder may be running: the interpreter's exit
# stops them first, since a daemon thread cut off inside torch while the
# interpreter finalizes aborts the process
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _stop_feeders():
    for pf in list(_LIVE):
        try:
            pf._join_feeder()
        except DataPipelineError:
            pass                  # a feeder stuck in its source: exit anyway


def _as_arrays(batch):
    """Normalize one source item to ``(kind, data_tuple, label_tuple,
    extra)`` where ``kind`` remembers the wire shape so the consumer
    sees the same type it fed in."""
    if isinstance(batch, DataBatch):
        return ("databatch", tuple(batch.data), tuple(batch.label),
                (batch.pad, batch.index))
    if isinstance(batch, (tuple, list)) and len(batch) == 2:
        data, labels = batch
        bare_d = not isinstance(data, (tuple, list))
        bare_l = not isinstance(labels, (tuple, list))
        if bare_d:
            data = (data,)
        if bare_l:
            labels = (labels,)
        return ("pair", tuple(data), tuple(labels), (bare_d, bare_l))
    raise DataPipelineError(
        f"DevicePrefetcher source yielded {type(batch).__name__}; "
        "expected a DataBatch or a (data, labels) pair")


def _rewrap(kind, data, labels, extra):
    if kind == "databatch":
        pad, index = extra
        return DataBatch(list(data), list(labels), pad=pad, index=index)
    bare_d, bare_l = extra
    return (data[0] if bare_d else data,
            labels[0] if bare_l else labels)


def _tensor(a) -> torch.Tensor:
    if isinstance(a, NDArray):
        return a.tensor
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(onp.ascontiguousarray(a))


def _nbytes(arrays) -> int:
    return sum(int(_tensor(a).nbytes) for a in arrays)


def _named(shardings):
    """The per-array mesh placements when ``shardings`` is a sequence of
    ``NamedSharding`` (checked), else None."""
    from ..parallel.sharding import NamedSharding, check_placement
    if isinstance(shardings, (list, tuple)) and shardings and all(
            isinstance(s, NamedSharding) for s in shardings):
        for s in shardings:
            check_placement(s)
        return list(shardings)
    return None


def _device_of(shardings, n):
    """The one device every batch array goes to, from ``shardings`` (a
    device or Context, a sequence of them with one per array, or one
    mesh placement per array: this rank's device)."""
    if isinstance(shardings, (str, torch.device, Context)):
        return resolve_device(shardings)
    if len(shardings) != n:
        raise DataPipelineError(
            f"{len(shardings)} shardings for {n} batch arrays")
    if _named(shardings) is not None:
        from ..parallel.distributed import local_device
        return local_device()
    devs = {resolve_device(s) for s in shardings}
    if len(devs) != 1:
        raise DataPipelineError(
            "DevicePrefetcher places a batch on one device or over a "
            f"mesh (NamedSharding); got devices {sorted(map(str, devs))}")
    return devs.pop()


class DevicePrefetcher:
    """Bounded ring of batches on the card fed by a background thread;
    iterator over batches shaped like the source's.

    Parameters
    ----------
    source : DataIter-shaped object or iterator/iterable
        Must yield DataBatch or (data, labels) pairs deterministically;
        needs ``reset()`` for re-iteration / offset fast-forward.
    shardings : device, or sequence of devices, or callable, optional
        Target placement of the flattened ``data + labels`` arrays —
        pass ``trainer.batch_shardings`` after the trainer's first step,
        or a device.  A callable is invoked per batch with the array
        tuple.  Mesh placements (``NamedSharding``, one per array) ship
        this rank's block of each global array to this rank's device,
        marked as a local shard (the same rows on every rank of a
        ``tp``, ``ep`` or ``pp`` line).  ``None``: the current context
        at construction.
    depth : int
        Ring capacity (>= 1; default 2 = double buffering).  The feeder
        blocks when the ring is full — a slow consumer can never make
        the ring grow past ``depth`` (backpressure).
    transform : callable, optional
        ``transform(data, labels, step) -> (data, labels)`` applied by
        the feeder after placement, on its stream — the on-device
        augment hook (:class:`~mxnet_tpu_torch.data.transforms.
        DeviceTransform`).
    stall_timeout : float
        Seconds the consumer waits on an empty ring before recording a
        ``data.stall`` flight-recorder event (diagnostic only; the wait
        itself is unbounded).
    """

    def __init__(self, source, shardings=None, depth: int = 2,
                 transform: Optional[Callable] = None,
                 stall_timeout: float = 1.0):
        if not isinstance(depth, int) or depth < 1:
            raise DataPipelineError(
                f"prefetch depth must be an int >= 1, got {depth!r}")
        if not (hasattr(source, "next") or hasattr(source, "__next__")
                or hasattr(source, "__iter__")):
            raise DataPipelineError(
                f"source {type(source).__name__} is not iterable")
        self._source = source
        self._shardings = shardings
        self._depth = depth
        self._transform = transform
        self._stall_timeout = stall_timeout
        self.batch_size = getattr(source, "batch_size", 0)
        # the source runs on the feeder's thread inside the scope it was
        # built in (``with mx.cpu():`` reaches its ``nd.array`` calls)
        self._scope = _context._scope()
        # the default target (a callable's None, or no shardings): the
        # current context here
        if isinstance(shardings, (list, tuple)):
            self._device = _device_of(shardings, len(shardings))
        elif shardings is None or callable(shardings):
            self._device = resolve_device(None)
        else:
            self._device = resolve_device(shardings)
        self._stream = None            # the feeder's stream, per device

        reg = _registry()
        self._m_wait = reg.histogram(
            "mxtpu_data_input_wait_seconds",
            help="time a consumer step blocked on the prefetch ring")
        self._m_depth = reg.gauge(
            "mxtpu_data_prefetch_depth",
            help="configured DevicePrefetcher ring capacity")
        self._m_shipped = reg.counter(
            "mxtpu_data_batches_shipped_total",
            help="batches placed on device ahead of the step")
        self._m_fallback = reg.counter(
            "mxtpu_data_batches_fallback_total",
            help="batches degraded to synchronous/host hand-off")
        self._m_bytes = reg.counter(
            "mxtpu_data_bytes_shipped_total",
            help="bytes moved host->device by the feeder")
        self._m_depth.set(depth)

        # ring state — everything below is guarded by _cond's lock
        self._cond = _named_condition(
            "data.prefetch", "DevicePrefetcher ring: feeder <-> consumer "
            "hand-off and backpressure")
        self._ring: deque = deque()
        self._fed = 0            # batches successfully enqueued
        self._consumed = 0       # batches yielded to the consumer
        self._stop = False
        self._crashed: Optional[BaseException] = None
        self._finished = False
        self._stalls = 0
        self.last_wait_seconds = 0.0
        self._wait_total = 0.0
        self._skip = 0
        # per-instance tallies (the registry counters above are shared
        # process-wide by get-or-create; stats() must not conflate two
        # pipelines)
        self._n_shipped = 0
        self._n_fallback = 0
        self._n_bytes = 0
        self._thread: Optional[threading.Thread] = None
        self._start()

    # ------------------------------------------------------------ source
    def _pull(self):
        """One item from the source (feeder thread, or consumer after a
        feeder crash — never both: ownership hands off exactly once)."""
        nxt = getattr(self._source, "next", None)
        if nxt is not None and not isinstance(self._source, _IterWrap):
            return nxt()
        return next(self._source_iter)

    def _start(self):
        if not hasattr(self._source, "next"):
            # plain iterable: keep ONE iterator for the pipeline's life
            if not isinstance(self._source, _IterWrap):
                self._source = _IterWrap(self._source)
        self._source_iter = self._source
        self._thread = threading.Thread(
            target=self._feed, name="mxtpu-data-feeder", daemon=True)
        _LIVE.add(self)
        self._thread.start()

    # ------------------------------------------------------------ feeder
    def _target(self, arrays):
        """(device, mesh placements or None) for one batch."""
        sh = self._shardings
        if callable(sh):
            sh = sh(arrays)
        if sh is None:
            return self._device, None
        return _device_of(sh, len(arrays)), _named(sh)

    def _copy(self, tensors, dev: torch.device):
        """The tensors on ``dev``; on the card, copied on the feeder's
        stream from page-locked memory.  Returns (tensors, event)."""
        if dev.type != "cuda":
            return [t.to(dev) for t in tensors], None
        if self._stream is None or self._stream.device != dev:
            self._stream = torch.cuda.Stream(dev)
        staged = [t if t.device.type != "cpu" or t.is_pinned()
                  else t.pin_memory() for t in tensors]
        with torch.cuda.stream(self._stream):
            out = [t if t.device == dev else t.to(dev, non_blocking=True)
                   for t in staged]
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _ship(self, data, labels):
        """Place one batch on the target device.  Returns (data, labels,
        shipped_bytes, event) — on a double ``data.device_put`` fault
        the original host arrays come back (the trainer's own copy
        covers that step)."""
        arrays = tuple(data) + tuple(labels)
        for attempt in (0, 1):
            try:
                _inject("data.device_put")
                dev, named = self._target(arrays)
                tensors = [_tensor(a) for a in arrays]
                if named is not None:
                    from ..parallel.sharding import (is_local_shard,
                                                     mark_local_shard)
                    # this rank's block of each global array
                    tensors = [t if is_local_shard(t) else
                               t[sh.local_slices(tuple(t.shape))]
                               .contiguous()
                               for t, sh in zip(tensors, named)]
                out, event = self._copy(tensors, dev)
                if named is not None:
                    out = [mark_local_shard(t, sh)
                           for t, sh in zip(out, named)]
                out = [NDArray(t) for t in out]
                nd = len(data)
                return (tuple(out[:nd]), tuple(out[nd:]),
                        _nbytes(arrays), event)
            except DataPipelineError:
                raise
            except Exception:
                if attempt:          # retried once already: degrade
                    self._m_fallback.inc()
                    self._n_fallback += 1
                    return tuple(data), tuple(labels), 0, None
        raise AssertionError("unreachable")   # pragma: no cover

    def _transformed(self, data, labels, step, event):
        """The transform hook, run on the feeder's stream after the copy
        (the stream orders it); returns (data, labels, event)."""
        if self._stream is None or event is None:
            data, labels = self._transform(data, labels, step)
            return data, labels, event
        with torch.cuda.stream(self._stream):
            data, labels = self._transform(data, labels, step)
            event = torch.cuda.Event()
            event.record(self._stream)
        return data, labels, event

    def _feed(self):
        if self._scope is None:
            return self._feed_loop()
        with self._scope:
            return self._feed_loop()

    def _feed_loop(self):
        main = threading.main_thread()
        try:
            while True:
                with self._cond:
                    while len(self._ring) >= self._depth and \
                            not self._stop and main.is_alive():
                        self._cond.wait(0.05)
                    if self._stop or not main.is_alive():
                        # interpreter teardown: stop touching the card
                        return
                sync_batch = False
                try:
                    # the fault site sits BEFORE the source read so a
                    # kill here leaves the offset clean for takeover
                    _inject("data.prefetch")
                except Exception:
                    sync_batch = True      # degrade: host hand-off
                try:
                    if self._skip:  # raceguard: unguarded(feeder-exclusive: _skip is written before _start() under a joined feeder, then owned by this thread)
                        for _ in range(self._skip):  # raceguard: unguarded(feeder-exclusive: see above)
                            self._pull()
                        self._skip = 0  # raceguard: unguarded(feeder-exclusive: see above)
                    item = self._pull()
                except StopIteration:
                    with self._cond:
                        self._ring.append(_END)
                        self._cond.notify_all()
                    return
                kind, data, labels, extra = _as_arrays(item)
                event = None
                if sync_batch:
                    self._m_fallback.inc()
                    self._n_fallback += 1
                else:
                    data, labels, nbytes, event = self._ship(data, labels)
                    if nbytes:
                        self._m_shipped.inc()
                        self._m_bytes.inc(nbytes)
                        self._n_shipped += 1
                        self._n_bytes += nbytes
                if self._transform is not None and not sync_batch:
                    data, labels, event = self._transformed(
                        data, labels, self._fed, event)  # raceguard: unguarded(feeder-exclusive: _fed is only advanced by this thread while it is alive)
                with self._cond:
                    if self._stop:
                        return
                    self._ring.append((kind, data, labels, extra, event))
                    self._fed += 1
                    self._cond.notify_all()
        except BaseException as e:         # includes SimulatedPreemption
            with self._cond:
                self._crashed = e
                self._cond.notify_all()
            fr = _fr_active()
            if fr is not None:
                fr.record("data.feeder_crash", error=type(e).__name__,
                          fed=self._fed, detail=str(e)[:200])  # raceguard: unguarded(final diagnostic read on the dying feeder thread)

    # ---------------------------------------------------------- consumer
    def _hand_over(self, data, labels, event):
        """Order the caller's current stream after the batch's copy and
        transform, and keep each tensor's memory from reuse until that
        stream has passed the work it queues next (the step that reads
        it)."""
        if event is None:
            return
        cur = torch.cuda.current_stream(self._stream.device)
        cur.wait_event(event)
        for a in (*data, *labels):
            t = _tensor(a)
            if t.is_cuda:
                t.record_stream(cur)

    def next(self):
        t0 = time.perf_counter()
        stalled = False
        with self._cond:
            while not self._ring and self._crashed is None \
                    and not self._finished:
                if not self._cond.wait(self._stall_timeout):
                    if not stalled:
                        stalled = True
                        self._stalls += 1
                        fr = _fr_active()
                        if fr is not None:
                            fr.record("data.stall",
                                      consumed=self._consumed,
                                      waited=round(
                                          time.perf_counter() - t0, 3))
            if self._ring:
                item = self._ring.popleft()
                self._cond.notify_all()
            elif self._finished:
                item = _END
            else:
                item = None                # feeder crashed, ring dry
        wait = time.perf_counter() - t0
        self.last_wait_seconds = wait
        self._wait_total += wait
        self._m_wait.observe(wait)
        if item is _END:
            self._finished = True  # raceguard: unguarded(consumer-exclusive: the feeder appends _END and exits, it never reads _finished)
            raise StopIteration
        if item is None:
            if isinstance(self._crashed, DataPipelineError):  # raceguard: unguarded(write-once: set by the feeder as its last act, observed non-None under the lock above)
                # the feeder died of pipeline misuse (malformed batch,
                # bad shardings) — surface it; takeover is for kills
                raise self._crashed  # raceguard: unguarded(write-once: see above)
            return self._takeover()
        kind, data, labels, extra, event = item
        self._hand_over(data, labels, event)
        self._consumed += 1  # raceguard: unguarded(consumer-exclusive: only next()/_takeover() on the consumer thread advance _consumed)
        return _rewrap(kind, data, labels, extra)

    def _takeover(self):
        """Feeder died (killed/crashed): the consumer now owns the
        source and degrades to synchronous pulls at the feeder's last
        clean offset — batches keep flowing, each one counted as a
        fallback, sequence unchanged."""
        try:
            if self._skip:  # raceguard: unguarded(takeover runs only after the feeder died — the consumer inherited sole ownership of the source state)
                for _ in range(self._skip):  # raceguard: unguarded(post-crash consumer ownership: see above)
                    self._pull()
                self._skip = 0  # raceguard: unguarded(post-crash consumer ownership: see above)
            item = self._pull()
        except StopIteration:
            self._finished = True  # raceguard: unguarded(post-crash consumer ownership: see above)
            raise
        kind, data, labels, extra = _as_arrays(item)
        data, labels, _, event = self._ship(data, labels)
        if self._transform is not None:
            data, labels, event = self._transformed(
                data, labels, self._consumed, event)  # raceguard: unguarded(post-crash consumer ownership: see above)
        self._hand_over(data, labels, event)
        self._m_fallback.inc()
        self._n_fallback += 1
        self._consumed += 1  # raceguard: unguarded(post-crash consumer ownership: see above)
        self._fed += 1  # raceguard: unguarded(post-crash consumer ownership: see above)
        return _rewrap(kind, data, labels, extra)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    # --------------------------------------------------------- lifecycle
    def _join_feeder(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive():
            # the feeder re-checks _stop at every blocking point within
            # 50ms, so a bounded join cannot leave a zombie reading the
            # source behind our back
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():    # pragma: no cover
                raise DataPipelineError(
                    "feeder thread failed to stop within 5s")

    def reset(self):
        """Stop the feeder, reset the source, restart from offset 0."""
        self._join_feeder()
        if hasattr(self._source, "reset"):
            self._source.reset()
        with self._cond:
            self._ring.clear()
            self._fed = 0
            self._consumed = 0
            self._stop = False
            self._crashed = None
            self._finished = False
            self._skip = 0
        self._start()

    def close(self):
        self._join_feeder()

    # ------------------------------------------------------------ resume
    def state_dict(self) -> dict:
        """The source offset (batches consumed); everything else —
        ring contents, feeder position — is derived state that a
        restore rebuilds by fast-forwarding the source."""
        return {"offset": self._consumed}  # raceguard: unguarded(consumer-thread snapshot: _consumed is consumer-exclusive and ResilientLoop checkpoints between steps)

    def load_state_dict(self, state: dict):
        off = int(state.get("offset", 0))
        if off < 0:
            raise DataPipelineError(f"negative resume offset {off}")
        self._join_feeder()
        if hasattr(self._source, "reset"):
            self._source.reset()
        with self._cond:
            self._ring.clear()
            self._fed = off
            self._consumed = off
            self._stop = False
            self._crashed = None
            self._finished = False
            self._skip = off       # feeder discards these before feeding
        self._start()

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._cond:
            ring = len(self._ring)
            return {
                "depth": self._depth,
                "ring_occupancy": ring,
                "fed": self._fed,
                "consumed": self._consumed,
                "stalls": self._stalls,
                "feeder_alive": (self._thread is not None
                                 and self._thread.is_alive()),
                "crashed": (type(self._crashed).__name__
                            if self._crashed is not None else None),
                "input_wait_seconds_total": round(self._wait_total, 6),
                "last_wait_seconds": round(self.last_wait_seconds, 6),
                "batches_shipped": self._n_shipped,
                "batches_fallback": self._n_fallback,
                "bytes_shipped": self._n_bytes,
            }

    def __repr__(self):
        return (f"DevicePrefetcher(depth={self._depth}, "
                f"consumed={self._consumed}, fed={self._fed})")  # raceguard: unguarded(repr diagnostic: atomic int reads, momentary staleness is harmless)


class _IterWrap:
    """Give a plain iterable/iterator a ``next()``/``reset()`` face so
    the feeder treats every source uniformly.  ``reset`` re-invokes
    ``iter()`` on the ORIGINAL object — generators are single-shot, so
    sources that must survive reset should be DataIter-shaped or pass a
    fresh pipeline per epoch (``ResilientLoop``'s make_iter does)."""

    def __init__(self, obj):
        self._obj = obj
        self._it = iter(obj)
        self.batch_size = getattr(obj, "batch_size", 0)
        # a generator IS its own iterator: single-shot, unresettable;
        # containers / DataIters hand out fresh iterators
        self.resettable = (hasattr(obj, "reset")
                           or iter(obj) is not self._it)

    def next(self):
        return next(self._it)

    def __next__(self):
        return next(self._it)

    def reset(self):
        if not self.resettable:
            raise DataPipelineError(
                "source is a single-shot iterator (generator) — "
                "reset/offset fast-forward needs a resettable source "
                "(DataIter, ShardedLoader, or a re-iterable container); "
                "ResilientLoop replay uses a FRESH pipeline per run() "
                "instead")
        if hasattr(self._obj, "reset"):
            self._obj.reset()
        self._it = iter(self._obj)
