"""`InferenceEngine` — the online serving front end, core only
(counterpart of ``mxnet_tpu/serving/engine.py``).

One background scheduler thread owns all device work; callers use
``submit()`` (returns an :class:`InferenceFuture`) or ``infer()``.  The
engine decodes a GPT-2 style LM (``prefill_slots``/``decode_step``) with
continuous batching over a persistent KV cache: each cycle admits queued
requests into free slots, prefills them in bucketed batches (every
prompt padded up to a seq bucket of the lattice, every batch up to a
batch bucket), then runs one fixed-shape decode step over every slot,
free ones parked at ``pos = Tmax``.

KV layouts: ``kv_layout='dense'`` gives each slot a full (Tmax, H, D)
row; ``'paged'`` carves the cache into fixed-size pages mapped by
per-slot page tables (:mod:`.kv_pages`), with ``kv_quant='int8'`` pages
and two read arms — ``paged_attention='kernel'`` (the default: the CUDA
paged-attention kernel reads pages in place) or ``'gather'`` (rows
gathered back, the reference arm).

Admission is page-budgeted: a request is admitted only when the pool can
hold its whole lifetime, ``prompt + max_new_tokens`` positions, and its
pages are claimed at admission.  The reference claims pages lazily and
preempts a victim when the pool runs dry; preemption is not in this
slice, so the port reserves up front and a running request can never
fault.  A blocked request waits at the front of the queue.

Not in this slice: the prefix cache, chunked prefill across cycles (a
prompt longer than the largest seq bucket is refused), speculation,
deadlines, overload control and preemption, the watchdog and fault
sites, KV tiers, migration, meshes, the metrics registry and
``debug_parity``.  The counters in ``stats()`` are plain integers.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..context import resolve_device
from .batcher import BucketLattice, DynamicBatcher
from .errors import (EngineStoppedError, InvalidRequestError,
                     QueueFullError, ServingError)
from .kv_pages import PagePool
from .kv_slots import SlotAllocator, SlotState
from .sampling import sample_tokens

__all__ = ["InferenceEngine", "InferenceFuture", "Request"]

_log = logging.getLogger(__name__)


class InferenceFuture:
    """Write-once result holder; safe across threads."""

    __slots__ = ("_ev", "_result", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc = None

    def set_result(self, value):
        if not self._ev.is_set():
            self._result = value
            self._ev.set()

    def set_exception(self, exc: BaseException):
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("result() wait timed out (the request may "
                               "still complete server-side)")
        if self._exc is not None:
            raise self._exc
        return self._result


class Request:
    __slots__ = ("payload", "prompt_len", "max_new_tokens", "eos_id",
                 "future", "t_submit", "t_enqueue", "temperature", "top_k",
                 "top_p", "seed")

    def __init__(self, payload, max_new_tokens, eos_id, temperature, top_k,
                 top_p, seed):
        self.payload = payload
        self.prompt_len = int(payload.shape[0])
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.future = InferenceFuture()
        self.t_submit = time.monotonic()
        self.t_enqueue = self.t_submit


def _percentiles(xs):
    if not xs:
        return {"count": 0, "p50": None, "p99": None, "mean": None}
    a = np.asarray(xs, dtype=np.float64)
    return {"count": int(a.size), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean())}


class InferenceEngine:
    """Serve a GPT-2 style model online.  See the module docstring.

    Parameters follow the reference: ``max_batch`` (the largest batch
    a prefill call takes), ``num_slots`` (decode concurrency, default
    ``max_batch``), ``max_length`` (KV length per slot, default the
    model's), ``batch_buckets``/``seq_buckets`` (the lattice),
    ``eos_id``, ``default_max_new_tokens``, ``kv_layout``,
    ``page_size``, ``num_pages`` (default: the dense-equivalent
    ``num_slots * max_length / page_size``), ``kv_quant`` and
    ``paged_attention``.  ``device`` is where the engine runs (default:
    the current CUDA device; raises without one): the model's
    parameters must already live there.  The queue holds at most
    ``QUEUE_DEPTH`` requests (beyond it ``submit`` raises
    :class:`QueueFullError`), and an idle engine waits up to
    ``MAX_WAIT_US`` for a batch to fill, as the reference's defaults.
    """

    QUEUE_DEPTH = 64
    MAX_WAIT_US = 2000.0

    def __init__(self, net, *, max_batch: int = 8,
                 num_slots: Optional[int] = None,
                 max_length: Optional[int] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None,
                 default_max_new_tokens: int = 16,
                 kv_layout: str = "dense", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 paged_attention: Optional[str] = None,
                 device=None):
        if not (hasattr(net, "prefill_slots") and hasattr(net, "decode_step")):
            raise ServingError(f"{type(net).__name__} lacks the serving "
                               "decode surface (prefill_slots/decode_step)")
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ServingError(f"the model's parameters live on "
                               f"{net.device}, the engine runs on "
                               f"{self.device}: initialize or load the "
                               "model on the engine's device")
        self.net = net
        self.max_batch = int(max_batch)
        self.eos_id = eos_id
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_length = int(max_length or net.max_length)
        if self.max_length > net.max_length:
            raise ServingError(
                f"max_length={self.max_length} exceeds the model's position "
                f"table (net.max_length={net.max_length})")
        self.num_slots = int(num_slots or max_batch)
        self.lattice = BucketLattice(
            batch_buckets, seq_buckets,
            max_batch=min(self.max_batch, self.num_slots),
            max_seq=self.max_length)
        if self.lattice.max_seq > self.max_length:
            raise ServingError(f"largest seq bucket {self.lattice.max_seq} "
                               f"exceeds KV length max_length="
                               f"{self.max_length}")
        self._alloc = SlotAllocator(self.num_slots)

        if kv_layout not in ("dense", "paged"):
            raise ServingError(f"kv_layout must be 'dense'|'paged', got "
                               f"{kv_layout!r}")
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        if kv_quant not in (None, "int8"):
            raise ServingError(f"kv_quant must be None|'int8', got "
                               f"{kv_quant!r}")
        if kv_quant and not self._paged:
            raise ServingError("kv_quant='int8' requires kv_layout='paged' "
                               "— the dense layout is the float reference")
        if paged_attention not in (None, "kernel", "gather"):
            raise ServingError(f"paged_attention must be None|'kernel'|"
                               f"'gather', got {paged_attention!r}")
        if paged_attention and not self._paged:
            raise ServingError("paged_attention picks the paged read arm; "
                               "set kv_layout='paged' first")
        self.kv_quant = kv_quant
        self.paged_attention = (paged_attention or "kernel") \
            if self._paged else None
        self._paged_kernel = self.paged_attention == "kernel"
        if self._paged:
            self.page_size = int(page_size)
            if self.page_size < 1 or self.max_length % self.page_size:
                raise ServingError(
                    f"page_size={page_size} must be >= 1 and divide "
                    f"max_length={self.max_length}")
            self._n_logical = self.max_length // self.page_size
            self.num_pages = int(num_pages) if num_pages is not None \
                else self.num_slots * self._n_logical
            if self.num_pages < self._n_logical:
                raise ServingError(
                    f"num_pages={self.num_pages} cannot hold even one "
                    f"worst-case request ({self._n_logical} pages of "
                    f"{self.page_size})")
            self._pool = PagePool(self.num_pages, self.page_size)
            # host-authoritative page table: row = slot (+ scratch row),
            # unassigned entries point at the zero page
            self._page_table = np.full(
                (self.num_slots + 1, self._n_logical), self._pool.scratch,
                dtype=np.int32)
            self._table_dev = None
        else:
            self.page_size = None
            self.num_pages = 0
            self._pool = None

        self._cond = threading.Condition()
        self._batcher = DynamicBatcher(self.QUEUE_DEPTH, cond=self._cond)
        self._step_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._caches = None
        self._counters = dict.fromkeys(
            ("submitted", "rejected", "shed", "admitted", "completed",
             "failed", "prompt_tokens", "tokens_generated",
             "padded_tokens", "prefill_batches", "decode_steps",
             "page_waits"), 0)
        self._counters_lock = threading.Lock()
        self._ttft = []
        self._latency = []

    # ------------------------------------------------------------- lifecycle
    def start(self):
        if self._thread is not None:
            raise ServingError("engine already started")
        if self._batcher.closed:
            raise ServingError("engine cannot be restarted once stopped — "
                               "build a fresh InferenceEngine")
        self._thread = threading.Thread(target=self._loop,
                                        name="mxnet_tpu_torch-serving",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop accepting requests, finish everything queued and in
        flight, then stop the scheduler.  A request the scheduler never
        ran (the engine was never started) fails with
        :class:`EngineStoppedError`: nothing is dropped silently."""
        self._batcher.close()
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        with self._step_lock:
            self._fail_all(EngineStoppedError("engine stopped — request "
                                              "was never run"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---------------------------------------------------------------- submit
    def submit(self, x, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               seed: int = 0) -> InferenceFuture:
        """Enqueue one prompt (1-D ints, or (1, T)); the future's result
        is the full sequence (prompt + generated) as np.int32.
        ``temperature <= 0`` (the default) is exact greedy argmax;
        otherwise the request samples with its own seeded generator."""
        if not (math.isfinite(float(temperature))
                and float(temperature) >= 0.0) or int(top_k) < 0 \
                or not 0.0 < float(top_p) <= 1.0:
            self._reject(InvalidRequestError(
                f"bad sampling params: need temperature >= 0 (finite), "
                f"top_k >= 0, 0 < top_p <= 1 — got temperature="
                f"{temperature}, top_k={top_k}, top_p={top_p}"))
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        arr = np.asarray(x, dtype=np.int32)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1:
            self._reject(InvalidRequestError(
                f"a decode request is ONE prompt: expected shape (T,) or "
                f"(1, T), got {arr.shape}"))
        mnt = int(self.default_max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        if arr.size < 1 or mnt < 1:
            self._reject(InvalidRequestError(
                f"need a non-empty prompt and max_new_tokens >= 1 (got "
                f"len={arr.size}, max_new_tokens={mnt})"))
        if arr.size > self.lattice.max_seq:
            self._reject(InvalidRequestError(
                f"prompt len {arr.size} exceeds the largest seq bucket "
                f"{self.lattice.max_seq} (chunked prefill is not ported)"))
        if arr.size + mnt > self.max_length:
            self._reject(InvalidRequestError(
                f"prompt len {arr.size} + {mnt} new tokens does not fit "
                f"the KV length ({self.max_length})"))
        req = Request(arr.copy(), mnt,
                      self.eos_id if eos_id is None else eos_id,
                      temperature, top_k, top_p, seed)
        self._count("submitted")
        try:
            self._batcher.put(req)
        except QueueFullError:
            self._count("shed")
            raise
        return req.future

    def _reject(self, exc: BaseException):
        self._count("rejected")
        raise exc

    def _count(self, key: str, n: int = 1):
        # callers' threads and the scheduler both count
        with self._counters_lock:
            self._counters[key] += n

    def infer(self, x, max_new_tokens: Optional[int] = None,
              eos_id: Optional[int] = None, temperature: float = 0.0,
              top_k: int = 0, top_p: float = 1.0, seed: int = 0):
        """Synchronous ``submit()`` + wait."""
        if self._thread is None:
            raise ServingError("engine not started — call start() or use "
                               "the context manager")
        return self.submit(x, max_new_tokens, eos_id, temperature, top_k,
                           top_p, seed).result()

    # ---------------------------------------------------------------- warmup
    def warmup(self) -> int:
        """Run the decode step and every (batch, seq) prefill point of the
        lattice once on scratch rows, so the first request pays no
        one-time cost (kernel builds, library handles, allocator growth).
        Needs an idle engine; returns the number of shapes run."""
        with self._step_lock:
            if self._alloc.active_count:
                raise ServingError("warmup needs an idle engine")
            s1 = self.num_slots + 1
            scratch = self._alloc.scratch
            self._run_decode(np.zeros((s1,), np.int32),
                             np.full((s1,), self.max_length, np.int32),
                             self._samp_rows([], s1))
            n = 1
            for bb, tb in self.lattice.prefill_points():
                self._run_prefill(np.zeros((bb, tb), np.int32),
                                  np.ones((bb,), np.int32),
                                  np.full((bb,), scratch, np.int32),
                                  self._samp_rows([], bb))
                n += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return n

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._counters_lock:
            c = dict(self._counters)
        return {
            "counters": c,
            "latency": {"ttft": _percentiles(list(self._ttft)),
                        "request": _percentiles(list(self._latency))},
            "engine": {"device": str(self.device),
                       "queued": len(self._batcher),
                       "active_slots": self._alloc.active_count,
                       "num_slots": self.num_slots,
                       "batch_buckets": list(self.lattice.batch_buckets),
                       "seq_buckets": list(self.lattice.seq_buckets),
                       "running": self._thread is not None},
            "slots": {"kv_layout": self.kv_layout,
                      "active_highwater": self._alloc.active_highwater,
                      "page_size": self.page_size,
                      "pages_total": self.num_pages,
                      "pages_free": self._pool.free_count
                      if self._pool is not None else 0},
            "quantized_kv": {"kv_quant": self.kv_quant,
                             "paged_attention": self.paged_attention},
        }

    # -------------------------------------------------------------- device
    def _ensure_caches(self):
        if self._caches is None:
            if self._paged:
                self._caches = self.net.init_page_cache(
                    self.num_pages + 1, self.page_size,
                    kv_quant=self.kv_quant)
            else:
                self._caches = self.net.init_slot_cache(
                    self.num_slots + 1, self.max_length)

    def _paged_kw(self):
        if not self._paged:
            return {}
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self._page_table).to(
                self.device)
        return {"page_table": self._table_dev,
                "paged_kernel": self._paged_kernel}

    def _dev(self, a):
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _samp_rows(reqs, n):
        """Per-row sampling arrays for ``n`` rows whose first
        ``len(reqs)`` carry requests (the rest greedy padding)."""
        temp = np.zeros((n,), np.float32)
        topk = np.zeros((n,), np.int32)
        topp = np.ones((n,), np.float32)
        seeds = np.zeros((n,), np.int64)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            temp[i], topk[i], topp[i], seeds[i] = (r.temperature, r.top_k,
                                                   r.top_p, r.seed)
        return temp, topk, topp, seeds

    def _sample(self, logits, samp, positions):
        temp, topk, topp, seeds = samp
        tok = sample_tokens(logits, self._dev(temp), self._dev(topk),
                            self._dev(topp), seeds, positions)
        return tok.cpu().numpy()

    def _run_prefill(self, toks, lens, sidx, samp):
        self._ensure_caches()
        logits, self._caches = self.net.prefill_slots(
            self._dev(toks), self._dev(lens), self._caches, self._dev(sidx),
            **self._paged_kw())
        return self._sample(logits, samp, lens - 1)

    def _run_decode(self, tok, pos, samp):
        self._ensure_caches()
        logits, self._caches = self.net.decode_step(
            self._dev(tok), self._caches, self._dev(pos), **self._paged_kw())
        return self._sample(logits, samp, pos)

    # ------------------------------------------------------------- scheduler
    def _loop(self):
        while True:
            with self._cond:
                if self._batcher.empty() and self._alloc.active_count == 0:
                    if self._stopping:
                        return
                    self._cond.wait(0.05)
                    continue
            try:
                with self._step_lock:
                    self._cycle()
            except Exception as e:  # boundary: never leave futures hung
                _log.exception("serving cycle failed; failing in-flight "
                               "requests")
                with self._step_lock:
                    self._fail_all(e)

    def _cycle(self):
        free = self._alloc.free_count
        if free and not self._batcher.empty():
            # only an idle engine waits for a batch to fill: with
            # requests in flight, arrivals ride the next cycle
            wait_us = self.MAX_WAIT_US if self._alloc.active_count == 0 \
                else 0
            self._admit(self._batcher.get_batch(
                min(free, self.lattice.max_batch), wait_us))
        self._prefill_cycle()
        if any(not st.prefilling for _s, st in self._alloc.items()):
            self._decode_step()

    def _fail(self, req: Request, exc: BaseException):
        req.future.set_exception(exc)
        self._count("failed")

    def _fail_all(self, exc: BaseException):
        """Fail every queued and in-flight request.  If any was in
        flight, drop the device caches too: a failed step may have left
        them half-written."""
        for req in self._batcher.drain():
            self._fail(req, exc)
        inflight = self._alloc.items()
        for slot, st in inflight:
            self._release(slot)
            self._fail(st.request, exc)
        if inflight:
            self._caches = None

    def _release(self, slot: int):
        st = self._alloc.free(slot)
        if self._paged:
            self._pool.release(st.pages)
            st.pages = []
            self._page_table[slot, :] = self._pool.scratch
            self._table_dev = None

    def _admit(self, reqs):
        """Lease a slot per live request.  Paged: admit only while the
        pool covers the request's whole lifetime, claiming its pages now;
        a blocked request and everything behind it go back to the front
        of the queue, in order."""
        for i, req in enumerate(reqs):
            pages = None
            if self._paged:
                need = self._pool.pages_for(
                    min(req.prompt_len + req.max_new_tokens,
                        self.max_length))
                pages = self._pool.alloc(need)
                if pages is None:
                    self._count("page_waits")
                    for r in reversed(reqs[i:]):
                        self._batcher.requeue(r)
                    break
            st = SlotState(req, req.prompt_len, req.max_new_tokens,
                           tokens=req.payload)
            slot = self._alloc.alloc(st)
            if pages is not None:
                st.pages = pages
                self._page_table[slot, :len(pages)] = pages
                self._table_dev = None
            self._count("admitted")
            self._count("prompt_tokens", req.prompt_len)

    def _prefill_cycle(self):
        """Full-prompt prefill of every admitted slot, grouped by seq
        bucket, at most ``lattice.max_batch`` rows per call."""
        groups = {}
        for slot, st in self._alloc.items():
            if st.prefilling:
                groups.setdefault(self.lattice.seq(st.prompt_len),
                                  []).append((slot, st))
        mb = self.lattice.max_batch
        for tb in sorted(groups):
            rows = groups[tb]
            for i in range(0, len(rows), mb):
                self._prefill_full(rows[i:i + mb], tb)

    def _prefill_full(self, rows, tb):
        bb = self.lattice.batch(len(rows))
        toks = np.zeros((bb, tb), np.int32)
        lens = np.ones((bb,), np.int32)
        sidx = np.full((bb,), self._alloc.scratch, np.int32)
        for i, (slot, st) in enumerate(rows):
            toks[i, :st.prompt_len] = st.tokens
            lens[i] = st.prompt_len
            sidx[i] = slot
        self._count("padded_tokens",
                    bb * tb - sum(st.prompt_len for _s, st in rows))
        self._count("prefill_batches")
        first = self._run_prefill(
            toks, lens, sidx,
            self._samp_rows([st.request for _s, st in rows], bb))
        for i, (slot, st) in enumerate(rows):
            st.t_first = time.monotonic()
            st.advance(int(first[i]))
            self._finish_if_done(slot, st)

    def _decode_step(self):
        """One fixed-shape step over all S+1 rows; rows not decoding
        (free slots, the scratch row) park at pos = Tmax."""
        s1 = self.num_slots + 1
        tok = np.zeros((s1,), np.int32)
        pos = np.full((s1,), self.max_length, np.int32)
        reqs = [None] * s1
        riders = []
        for slot, st in self._alloc.items():
            if st.prefilling:
                continue
            tok[slot] = st.last_token
            pos[slot] = st.pos
            reqs[slot] = st.request
            riders.append((slot, st))
        self._count("decode_steps")
        nxt = self._run_decode(tok, pos, self._samp_rows(reqs, s1))
        for slot, st in riders:
            st.advance(int(nxt[slot]))
            self._finish_if_done(slot, st)

    def _finish_if_done(self, slot: int, st: SlotState):
        if st.done or (st.request.eos_id is not None
                       and st.last_token == st.request.eos_id):
            self._release(slot)
            self._complete(st)

    def _complete(self, st: SlotState):
        req = st.request
        now = time.monotonic()
        self._ttft.append(st.t_first - req.t_submit)
        self._latency.append(now - req.t_submit)
        self._count("completed")
        self._count("tokens_generated", len(st.generated))
        req.future.set_result(np.concatenate(
            [req.payload, np.asarray(st.generated, np.int32)]))
