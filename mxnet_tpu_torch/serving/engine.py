"""`InferenceEngine` — the online serving front end (counterpart of
``mxnet_tpu/serving/engine.py``).

One background scheduler thread owns all device work; callers use
``submit()`` (returns an :class:`InferenceFuture`) or ``infer()``.  The
engine decodes a GPT-2 style LM (``prefill_slots``/``decode_step``) with
continuous batching over a persistent KV cache.  Each cycle admits
queued requests into free slots (a prefix-cache hit skips the matched
positions), claims the pages the cycle will write, prefills, then runs
one fixed-shape decode step over every slot, free ones parked at
``pos = Tmax`` — or, with ``spec_tokens``, one speculative cycle.

Prefill: a fresh prompt of at most ``prefill_chunk`` tokens takes the
full path (every prompt padded up to a seq bucket, every batch up to a
batch bucket; flash attention on the card).  Longer prompts, and the
suffix behind a prefix hit, prefill in chunks of at most
``prefill_chunk`` tokens behind the positions already cached, one chunk
batch per cycle, oldest admission first (the offset path: the paged
kernel arm launches the paged-attention kernel with ``Tq`` the chunk
bucket).  A prompt may be as long as ``max_length - max_new_tokens``.

KV layouts: ``kv_layout='dense'`` gives each slot a full (Tmax, H, D)
row; ``'paged'`` carves the cache into fixed-size pages mapped by
per-slot page tables (:mod:`.kv_pages`), with ``kv_quant='int8'`` pages
and two read arms — ``paged_attention='kernel'`` (the default: the CUDA
paged-attention kernel reads pages in place; on the card the engine
refuses a model whose head dim the kernel is not built for) or
``'gather'`` (rows gathered back, the reference arm).

Paged memory is claimed lazily: admission needs the prompt plus the
first decode page against a running budget (free pages plus what
evicting idle prefix entries would free), and pages grow as a slot
writes.  When the pool runs dry the youngest admission is preempted by
reference: its progress becomes an evictable prefix entry, and its
continuation requeues at the front with the same future and resumes by
prefix hit.  The reference ranks victims by priority class first; the
port has one class.

Prefix cache: the dense layout reserves ``prefix_pool_rows`` rows and
copies a hit's positions row to row; the paged layout is always on,
sharing whole pages by refcount and copying a partial tail page.

Speculative decode (``spec_tokens=k``, ``draft_layers``): an early-exit
drafter proposes k tokens per slot, one verify forward over the
(S, k + 1) window samples the model's own token at every position, and
the longest matching draft prefix plus one correction or bonus token is
accepted — streams are those of plain decode, greedy or sampled.

Compiled programs (the reference's jit cache and compile freeze):
every device call of the engine is a :class:`~.graphs.Program` keyed
as the reference keys its programs — the decode step, full and chunk
prefill per (batch, seq) bucket, the draft and the verify window, the
prefix copy, and the forward per batch bucket.  On the card each is one
CUDA graph, captured at its first call and replayed after; ``warmup()``
captures the whole lattice, and after it ``compiles`` stays where it is
and every call counts a ``bucket_hit`` (``stats()["compile"]``,
``stats()["compile_cache"]``).  On the CPU the same programs run their
functions on the same static buffers.  The private class attribute
``_graphs`` (an instance may set it False before ``warmup()``) runs the
programs eagerly on the card: a comparison arm, never a fallback.

Forward mode (``mode='forward'``, the default for a block without the
decode surface): any block served by dynamic batching — requests of one
example each, grouped by shape and dtype, padded to a batch bucket, one
program per (bucket, shape), rows scattered back — in predict mode with
no autograd recording.

Not in this slice: deadlines and ``cancel``, priority classes and
overload control, the watchdog, fault sites and NaN guard, KV tiers,
migration, meshes, the wiring to ``serving/metrics.py`` and the metrics
registry, and ``debug_parity`` (ROADMAP queue A2.6).  The counters in
``stats()`` are plain integers under the reference's names.  The
engine's locks come from the lock witness under the reference's site
names.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..analysis.lockwitness import (named_condition as _named_condition,
                                    named_lock as _named_lock)
from ..base import training_mode
from ..context import resolve_device
from ..models.transformer import copy_cache_rows
from ..ops.paged import KERNEL_HEAD_DIMS
from .batcher import BucketLattice, DynamicBatcher
from .errors import (EngineStoppedError, InvalidRequestError,
                     QueueFullError, ServingError)
from .graphs import Program
from .kv_pages import PagedPrefixCache, PagePool
from .kv_slots import SlotAllocator, SlotState
from .prefix_cache import PrefixCache
from .sampling import sample_tokens

__all__ = ["InferenceEngine", "InferenceFuture", "Request"]

_log = logging.getLogger(__name__)

_COUNTERS = (
    "submitted", "rejected", "shed", "admitted", "completed", "failed",
    "prompt_tokens", "tokens_generated", "padded_tokens",
    "prefill_batches", "prefill_chunks", "decode_steps",
    # paged memory: admissions and growths the pool could not cover,
    # preempted requests and their re-admissions
    "page_faults", "preemptions", "preempt_resumes",
    # prefix cache
    "prefix_hits", "prefix_misses", "prefix_tokens_saved",
    "prefix_inserts", "prefix_evictions",
    # speculative decode
    "spec_cycles", "spec_tokens_proposed", "spec_tokens_accepted",
    "spec_pages_rewound",
    # forward mode
    "forward_batches",
    # compiled programs: first calls (captures) and later calls
    "compiles", "bucket_hits")


class _NoSlots:
    """Forward mode's slot allocator: no KV slots, none in flight."""

    num_slots = free_count = active_count = active_highwater = 0

    @staticmethod
    def items():
        return []


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
                 "future", "t_submit", "t_enqueue", "t_first", "temperature",
                 "top_k", "top_p", "seed", "preempted", "shape_key")

    def __init__(self, payload, max_new_tokens, eos_id, temperature, top_k,
                 top_p, seed):
        self.payload = payload
        self.prompt_len = int(payload.shape[0]) if payload.ndim else 1
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.future = InferenceFuture()
        self.t_submit = time.monotonic()
        self.t_enqueue = self.t_submit
        self.t_first = None           # the request's first token, any run
        self.preempted = 0            # times preempted (slot reclaimed)
        self.shape_key = None         # forward mode: (shape, dtype name)


_MESH_POINT = "1dev"


def _host(t):
    """A program's output on the host, as a numpy copy."""
    return t.cpu().numpy().copy()


def _percentiles(xs):
    if not xs:
        return {"count": 0, "p50": None, "p99": None, "mean": None}
    a = np.asarray(xs, dtype=np.float64)
    return {"count": int(a.size), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean())}


class InferenceEngine:
    """Serve a GPT-2 style model online, or any block in forward mode.
    See the module docstring.

    ``mode`` is ``'decode'`` or ``'forward'``; None picks decode when
    the net has the decode surface (``prefill_slots``/``decode_step``)
    and forward otherwise.  Parameters follow the reference:
    ``max_batch`` (the largest batch a prefill or forward call takes),
    ``num_slots`` (decode concurrency, default ``max_batch``),
    ``max_length`` (KV length per slot, default the model's),
    ``batch_buckets``/``seq_buckets`` (the lattice), ``eos_id``,
    ``default_max_new_tokens``, ``prefix_pool_rows`` (dense
    prefix-cache rows, 0 = off; ignored when paged), ``prefill_chunk``
    (tokens per prefill call, default the largest seq bucket),
    ``prefix_min_tokens`` (the shortest prefix worth caching or
    copying), ``kv_layout``, ``page_size``, ``num_pages`` (default: the
    dense-equivalent ``num_slots * max_length / page_size``),
    ``kv_quant``, ``paged_attention``, ``spec_tokens`` (speculation
    depth k, 0 = off) and ``draft_layers`` (the drafter's blocks, fewer
    than the model's).  ``device`` is where the engine runs (default:
    the current CUDA device; raises without one): the model's
    parameters must already live there.  The queue holds at most
    ``QUEUE_DEPTH`` requests (beyond it ``submit`` raises
    :class:`QueueFullError`), and an idle engine waits up to
    ``MAX_WAIT_US`` for a batch to fill, as the reference's defaults.
    """

    QUEUE_DEPTH = 64
    MAX_WAIT_US = 2000.0
    # programs are CUDA graphs on the card; False runs them eagerly (a
    # comparison arm for the card and its tests, set before warmup())
    _graphs = True

    def __init__(self, net, mode: Optional[str] = None, *,
                 max_batch: int = 8,
                 num_slots: Optional[int] = None,
                 max_length: Optional[int] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None,
                 default_max_new_tokens: int = 16,
                 prefix_pool_rows: int = 0,
                 prefill_chunk: Optional[int] = None,
                 prefix_min_tokens: int = 4,
                 kv_layout: str = "dense", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 paged_attention: Optional[str] = None,
                 spec_tokens: int = 0, draft_layers: int = 1,
                 device=None):
        decodes = hasattr(net, "prefill_slots") and \
            hasattr(net, "decode_step")
        if mode is None:
            mode = "decode" if decodes else "forward"
        if mode not in ("decode", "forward"):
            raise ServingError(f"mode must be 'decode'|'forward', got "
                               f"{mode!r}")
        if mode == "decode" and not decodes:
            raise ServingError(f"{type(net).__name__} lacks the serving "
                               "decode surface (prefill_slots/decode_step)")
        if kv_layout not in ("dense", "paged"):
            raise ServingError(f"kv_layout must be 'dense'|'paged', got "
                               f"{kv_layout!r}")
        if kv_layout == "paged" and mode != "decode":
            raise ServingError("kv_layout='paged' is a decode-mode layout "
                               "(forward mode has no KV cache to page)")
        self.mode = mode
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
        self._cond = _named_condition(
            "serving.engine.cond", "admission queue + scheduler wakeups")
        self._batcher = DynamicBatcher(self.QUEUE_DEPTH, cond=self._cond)
        self._step_lock = _named_lock(
            "serving.engine.step", "in-flight state vs stop()")
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._caches = None
        self._table_dev = None
        self._counters = dict.fromkeys(_COUNTERS, 0)
        self._counters_lock = _named_lock(
            "serving.metrics", "per-engine counter/histogram state")
        self._ttft = []
        self._latency = []
        # the compiled programs by key, their shared memory pool and
        # capture stream (made at the first capture)
        self._programs = {}
        self._graph_pool = None
        self._graph_stream = None
        if mode == "forward":
            if int(spec_tokens):
                raise ServingError("spec_tokens is a decode-mode knob "
                                   "(forward mode has no decode loop to "
                                   "speculate)")
            self.lattice = BucketLattice(batch_buckets, (1,),
                                         max_batch=self.max_batch)
            # no KV state: an allocator with no slots and no caches, so
            # the scheduler, failure and stats paths run unguarded
            self.num_slots = 0
            self._alloc = _NoSlots()
            self._caches = ()
            self.kv_layout = kv_layout
            self.kv_quant = self.paged_attention = self.page_size = None
            self.num_pages = 0
            self._pool = self._prefix = None
            return
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
        self.prefix_pool_rows = int(prefix_pool_rows)
        if self.prefix_pool_rows < 0:
            raise ServingError(f"prefix_pool_rows must be >= 0, got "
                               f"{self.prefix_pool_rows}")
        self.prefill_chunk = int(prefill_chunk) \
            if prefill_chunk is not None else self.lattice.max_seq
        if self.prefill_chunk < 1:
            raise ServingError(f"prefill_chunk must be >= 1, got "
                               f"{self.prefill_chunk}")
        self.prefill_chunk = min(self.prefill_chunk, self.lattice.max_seq)
        self.prefix_min_tokens = max(1, int(prefix_min_tokens))

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
        if self._paged_kernel and self.device.type == "cuda":
            head_dim = net.kv_heads()[1]
            if head_dim not in KERNEL_HEAD_DIMS:
                raise ServingError(
                    f"the paged-attention kernel takes head dims "
                    f"{KERNEL_HEAD_DIMS}, the model's is {head_dim}: serve "
                    "it with paged_attention='gather'")
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
            # unassigned entries point at the zero page; the device copy
            # is refreshed once a cycle (``_sync_table``)
            self._page_table = np.full(
                (self.num_slots + 1, self._n_logical), self._pool.scratch,
                dtype=np.int32)
            self._table_stale = True
            # the paged prefix cache reserves nothing (its entries are
            # evictable refcounts on the pool), so it is always on
            self.prefix_pool_rows = 0
            self._prefix = PagedPrefixCache(
                self._pool, min_tokens=self.prefix_min_tokens)
        else:
            self.page_size = None
            self.num_pages = 0
            self._pool = None
            self._prefix = PrefixCache(
                self.prefix_pool_rows, row_base=self.num_slots + 1,
                min_tokens=self.prefix_min_tokens) \
                if self.prefix_pool_rows else None
        self.spec_tokens = int(spec_tokens)
        self.draft_layers = int(draft_layers)
        if self.spec_tokens < 0:
            raise ServingError(f"spec_tokens must be >= 0, got "
                               f"{self.spec_tokens}")
        if self.spec_tokens:
            if not (hasattr(net, "draft_slots")
                    and hasattr(net, "verify_slots")):
                raise ServingError(
                    f"{type(net).__name__} lacks the speculative decode "
                    "surface (draft_slots/verify_slots) — set "
                    "spec_tokens=0 to serve it")
            if self.spec_tokens + 1 > self.max_length:
                raise ServingError(
                    f"spec_tokens={self.spec_tokens} leaves no room for "
                    f"the verify window in max_length={self.max_length}")
            n_blocks = len(net.blocks)
            if not 1 <= self.draft_layers < n_blocks:
                raise ServingError(
                    f"draft_layers={self.draft_layers} must be >= 1 and < "
                    f"the model's layer count ({n_blocks}) — the drafter "
                    "must be cheaper than the verify forward")
        # whether every decoding slot got pages for the whole speculation
        # window this cycle; a shortfall degrades the cycle to plain
        # decode rather than preempting for an optimization
        self._spec_pages_ok = True

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
        flight, then stop the scheduler and release the compiled
        programs.  A request the scheduler never ran (the engine was
        never started) fails with :class:`EngineStoppedError`: nothing
        is dropped silently."""
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
            # a stopped engine never runs again: its graphs and their
            # pool go now, not whenever a collection breaks the cycle
            # through the programs' bound methods
            self._programs.clear()
            self._graph_pool = self._graph_stream = None

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
        is the full sequence (prompt + generated) as np.int32.  Prompts
        longer than the largest seq bucket prefill in chunks; prompt +
        ``max_new_tokens`` must fit ``max_length``.
        ``temperature <= 0`` (the default) is exact greedy argmax;
        otherwise the request samples with its own seeded noise.
        Forward mode: ``x`` is ONE example without the batch dim, and
        the result is the block's output row (a tuple of rows for a
        block with several outputs) as numpy."""
        if self.mode == "forward":
            return self._submit_forward(x, temperature, top_k, top_p, seed)
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

    def _submit_forward(self, x, temperature, top_k, top_p, seed):
        if temperature or top_k or top_p != 1.0 or seed:
            self._reject(InvalidRequestError(
                "sampling parameters (temperature/top_k/top_p/seed) are a "
                "decode-mode surface — a forward request has no token "
                "distribution to sample"))
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        arr = np.array(x)
        req = Request(arr, 0, None, 0.0, 0, 1.0, 0)
        req.shape_key = (tuple(arr.shape), str(arr.dtype))
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
    def warmup(self, example_shape: Optional[Sequence[int]] = None,
               dtype: str = "float32") -> int:
        """Compile the whole lattice, so that no request pays a capture
        and ``compiles`` stays where it is afterwards.  Decode mode: the
        decode step, every (batch, seq) point of the full and the chunk
        prefill lattices (capped at the ``prefill_chunk`` bucket), with
        speculation the draft and the verify window, and with a prefix
        cache the row copy (one program: src, dst and length are device
        scalars), each run once on scratch rows.  Forward mode: one
        forward per batch bucket for examples of ``example_shape`` (no
        batch dim) and ``dtype``.  Needs an idle engine; returns the
        number of programs compiled, as the reference's does."""
        with self._step_lock:
            before = self._counters["compiles"]
            if self.mode == "forward":
                if example_shape is None:
                    raise ServingError("forward-mode warmup needs "
                                       "example_shape (per-example, no "
                                       "batch dim)")
                shape = tuple(int(d) for d in example_shape)
                dt = np.dtype(dtype)
                for bb in self.lattice.batch_buckets:
                    self._forward_program(np.zeros((bb,) + shape, dt),
                                          (shape, str(dt)))
                return self._counters["compiles"] - before
            if self._alloc.active_count:
                raise ServingError("warmup needs an idle engine")
            s1 = self.num_slots + 1
            scratch = self._alloc.scratch
            self._sync_table()
            idle_tok = np.zeros((s1,), np.int32)
            idle_pos = np.full((s1,), self.max_length, np.int32)
            self._run_decode(idle_tok, idle_pos, self._samp_rows([], s1))
            if self.spec_tokens:
                self._run_spec(idle_tok, idle_pos, self._samp_rows([], s1))
            for bb, tb in self.lattice.prefill_points(self.prefill_chunk):
                args = (np.zeros((bb, tb), np.int32), np.ones((bb,), np.int32),
                        np.full((bb,), scratch, np.int32),
                        self._samp_rows([], bb))
                self._run_prefill(*args)
                self._run_prefill(*args, off=np.zeros((bb,), np.int32))
            if self._prefix is not None:
                # the paged layout's tail-page copy: the zero page onto
                # itself, length 0
                scr = self._pool.scratch if self._paged else scratch
                self._copy_rows(scr, scr, 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return self._counters["compiles"] - before

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._counters_lock:
            c = dict(self._counters)
        pref = c["prefix_hits"] + c["prefix_misses"]
        lookups = c["bucket_hits"] + c["compiles"]
        return {
            "counters": c,
            "latency": {"ttft": _percentiles(list(self._ttft)),
                        "request": _percentiles(list(self._latency))},
            "engine": {"device": str(self.device),
                       "mode": self.mode,
                       "queued": len(self._batcher),
                       "active_slots": self._alloc.active_count,
                       "num_slots": self.num_slots,
                       "batch_buckets": list(self.lattice.batch_buckets),
                       "seq_buckets": list(self.lattice.seq_buckets),
                       "prefix_entries": len(self._prefix)
                       if self._prefix is not None else 0,
                       "running": self._thread is not None},
            "slots": {"kv_layout": self.kv_layout,
                      "active_highwater": self._alloc.active_highwater,
                      "page_size": self.page_size,
                      "pages_total": self.num_pages,
                      "pages_free": self._pool.free_count
                      if self._pool is not None else 0,
                      "pages_shared": self._pool.shared_count
                      if self._pool is not None else 0},
            # accepted / proposed drafts (the bonus token each cycle
            # banks is not proposed, so a useless drafter reads 0.0)
            "rates": {
                "prefix_hit_rate": round(c["prefix_hits"] / pref, 4)
                if pref else None,
                "spec_acceptance_rate": round(
                    c["spec_tokens_accepted"] / c["spec_tokens_proposed"],
                    4) if c["spec_tokens_proposed"] else None},
            "quantized_kv": {"kv_quant": self.kv_quant,
                             "paged_attention": self.paged_attention},
            # one engine serves one mesh point; the port has one
            "compile": {"mesh_point": _MESH_POINT,
                        "by_mesh_point": {_MESH_POINT: c["compiles"]}
                        if c["compiles"] else {},
                        "compiles": c["compiles"],
                        "bucket_hits": c["bucket_hits"],
                        # each program compiles once
                        "programs": c["compiles"]},
            "compile_cache": {"bucket_hits": c["bucket_hits"],
                              "compiles": c["compiles"],
                              "hit_rate": round(c["bucket_hits"] / lookups,
                                                4) if lookups else None},
        }

    # ------------------------------------------------------------- programs
    def _call(self, key, fn, *args):
        """Run program ``key`` (``fn`` over static buffers shaped by
        ``args``): its first call compiles it (a capture on the card),
        every later one is a bucket hit.  Caches and the page table are
        allocated before the first program runs."""
        self._ensure_caches()
        prog = self._programs.get(key)
        if prog is None:
            self._count("compiles")
            graph = self._graphs and self.device.type == "cuda"
            if graph and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._graph_stream = torch.cuda.Stream(self.device)
            prog = Program(key, fn, args, self.device, graph=graph,
                           pool=self._graph_pool, stream=self._graph_stream)
            self._programs[key] = prog
        else:
            self._count("bucket_hits")
        return prog(*args)

    def _ensure_caches(self):
        """The persistent device state every program captures: the KV
        caches and the page table.  Allocated once; a failure zeroes
        them in place (``_fail_all``)."""
        if self._caches is not None:
            return
        if self._paged:
            self._caches = self.net.init_page_cache(
                self.num_pages + 1, self.page_size,
                kv_quant=self.kv_quant)
            self._table_dev = torch.from_numpy(
                self._page_table.copy()).to(self.device)
            self._table_stale = False
        else:
            # slots + scratch + prefix pool rows
            self._caches = self.net.init_slot_cache(
                self.num_slots + 1 + self.prefix_pool_rows,
                self.max_length)

    def _sync_table(self):
        """Upload the page table into its static device buffer if it
        changed: once a cycle, after every claim and before the first
        launch.  Changes made later in the cycle (a release at the first
        or last token, a speculation rewind) only drop pages from rows
        that no later launch of the cycle writes through: a released row
        is parked at ``Tmax`` and a rewound one writes at positions its
        kept pages cover, and no page is claimed again before the next
        cycle's upload."""
        self._ensure_caches()
        if self._paged and self._table_stale:
            # a snapshot: the host table changes during the cycle, the
            # device copy stays as uploaded (as the card's does)
            self._table_dev.copy_(torch.from_numpy(self._page_table))
            self._table_stale = False

    def _paged_kw(self):
        if not self._paged:
            return {}
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

    # The programs' functions: device tensors in, device tensors out, no
    # host read; each reads the caches and the page table it captured.
    def _prog_decode(self, tok, pos, temp, topk, topp, seeds):
        logits, _ = self.net.decode_step(tok, self._caches, pos,
                                         **self._paged_kw())
        return sample_tokens(logits, temp, topk, topp, seeds, pos)

    def _prog_prefill(self, toks, lens, sidx, temp, topk, topp, seeds):
        logits, _ = self.net.prefill_slots(toks, lens, self._caches, sidx,
                                           **self._paged_kw())
        return sample_tokens(logits, temp, topk, topp, seeds, lens - 1)

    def _prog_chunk(self, toks, lens, sidx, off, temp, topk, topp, seeds):
        logits, _ = self.net.prefill_slots(toks, lens, self._caches, sidx,
                                           offset=off, **self._paged_kw())
        return sample_tokens(logits, temp, topk, topp, seeds,
                             off + lens - 1)

    def _prog_draft(self, tok, pos, temp, topk, topp, seeds):
        return self.net.draft_slots(
            tok, self._caches, pos, self.spec_tokens, self.draft_layers,
            temp, topk, topp, seeds,
            page_table=self._table_dev if self._paged else None)

    def _prog_verify(self, tok, draft, pos, temp, topk, topp, seeds):
        """The (S, k + 1) window [tok, drafts]: its K/V are written and
        every column is sampled at its own position ``pos + i``, the
        (request seed, position) plain decode would use there.  Returns
        the verify tokens and the drafts (this program's own input
        buffer, which no later replay overwrites)."""
        logits, _ = self.net.verify_slots(
            torch.cat([tok[:, None], draft], dim=1), self._caches, pos,
            **self._paged_kw())
        s, w, v = logits.shape

        def rep(a):
            return a[:, None].expand(s, w).reshape(s * w)
        fpos = (pos[:, None].to(torch.int64)
                + torch.arange(w, device=pos.device)).reshape(s * w)
        vt = sample_tokens(logits.reshape(s * w, v), rep(temp), rep(topk),
                           rep(topp), rep(seeds), fpos)
        return vt.reshape(s, w), draft

    def _prog_copy(self, src, dst, length):
        copy_cache_rows(self._caches, src, dst, length)

    def _prog_forward(self, xs):
        """The block's output: one tensor, or a tuple of them."""
        with training_mode(False):
            out = self.net(xs)
        return out if isinstance(out, torch.Tensor) else tuple(out)

    # The engine's device calls, each one program call.
    def _run_prefill(self, toks, lens, sidx, samp, off=None):
        """One full (``off=None``) or chunked prefill call; the token
        sampled at each row's last real position."""
        bb, tb = toks.shape
        if off is None:
            tok = self._call(("prefill", bb, tb), self._prog_prefill, toks,
                             lens, sidx, *samp)
        else:
            tok = self._call(("chunk", bb, tb), self._prog_chunk, toks,
                             lens, sidx, off, *samp)
        return _host(tok)

    def _run_decode(self, tok, pos, samp):
        return _host(self._call(("decode",), self._prog_decode, tok, pos,
                                *samp))

    def _run_spec(self, tok, pos, samp):
        """Draft k tokens per row (read-only on the caches), then verify
        the window.  Returns (drafts (S, k), verify tokens (S, k + 1))
        on the host."""
        draft = self._call(("draft",), self._prog_draft, tok, pos, *samp)
        vt, draft = self._call(("verify",), self._prog_verify, tok, draft,
                               pos, *samp)
        return _host(draft), _host(vt)

    def _copy_rows(self, src, dst, length):
        """Positions ``[0, length)`` of cache row (or page) ``src`` into
        ``dst``: the prefix copy program."""
        self._call(("prefix_copy",), self._prog_copy,
                   *(np.asarray(v, np.int64) for v in (src, dst, length)))

    def _forward_program(self, xs, shape_key):
        return self._call(("forward", xs.shape[0]) + shape_key,
                          self._prog_forward, xs)

    # ------------------------------------------------------------- scheduler
    def _loop(self):
        cycle = self._forward_cycle if self.mode == "forward" \
            else self._cycle
        while True:
            with self._cond:
                if self._batcher.empty() and self._alloc.active_count == 0:
                    if self._stopping:
                        return
                    self._cond.wait(0.05)
                    continue
            try:
                with self._step_lock:
                    cycle()
            except Exception as e:  # boundary: never leave futures hung
                _log.exception("serving cycle failed; failing in-flight "
                               "requests")
                with self._step_lock:
                    self._fail_all(e)

    def _cycle(self):
        """Admit; claim every page the cycle writes (prefill chunks, the
        first decode page of a prompt finishing now, decode growth and
        the speculation window); upload the table once; prefill; then one
        decode step or one speculative cycle."""
        free = self._alloc.free_count
        if free and not self._batcher.empty():
            # only an idle engine waits for a batch to fill: with
            # requests in flight, arrivals ride the next cycle
            wait_us = self.MAX_WAIT_US if self._alloc.active_count == 0 \
                else 0
            self._admit(self._batcher.get_batch(
                min(free, self.lattice.max_batch), wait_us))
        full, chunked, finishing = self._plan_prefill()
        if self._paged:
            self._grow_pages(finishing)
        self._sync_table()
        for tb in sorted(full):
            rows = [(s, st) for s, st in full[tb] if s in self._alloc]
            mb = self.lattice.max_batch
            for i in range(0, len(rows), mb):
                self._prefill_full(rows[i:i + mb], tb)
        chunked = [(s, st) for s, st in chunked if s in self._alloc]
        if chunked:
            self._prefill_chunk_batch(chunked)
        if any(not st.prefilling for _s, st in self._alloc.items()):
            if self.spec_tokens and self._spec_pages_ok:
                self._spec_step()
            else:
                self._decode_step()

    def _forward_cycle(self):
        """One forward batch: requests of one (shape, dtype), padded to
        a batch bucket, one program call, rows scattered back."""
        reqs = self._batcher.get_batch(self.max_batch, self.MAX_WAIT_US,
                                       compatible=lambda r: r.shape_key)
        if not reqs:
            return
        bb = self.lattice.batch(len(reqs))
        xs = np.stack([r.payload for r in reqs] +
                      [np.zeros_like(reqs[0].payload)] * (bb - len(reqs)))
        self._count("admitted", len(reqs))
        self._count("forward_batches")
        try:
            out = self._forward_program(xs, reqs[0].shape_key)
            single = isinstance(out, torch.Tensor)
            outs = [_host(o) for o in ((out,) if single else out)]
        except Exception as e:  # the popped batch fails, the queue stays
            for r in reqs:
                self._fail(r, e)
            return
        done = time.monotonic()
        for i, r in enumerate(reqs):
            self._latency.append(done - r.t_submit)
            self._count("completed")
            r.future.set_result(outs[0][i] if single
                                else tuple(o[i] for o in outs))

    def _fail(self, req: Request, exc: BaseException):
        req.future.set_exception(exc)
        self._count("failed")

    def _fail_all(self, exc: BaseException):
        """Fail every queued and in-flight request.  If any was in
        flight, zero the device caches too (a failed step may have left
        them half-written), and drop every prefix entry and page
        claim."""
        for req in self._batcher.drain():
            self._fail(req, exc)
        inflight = self._alloc.items()
        for slot, st in inflight:
            self._release(slot)
            self._fail(st.request, exc)
        if inflight:
            if self._caches is not None:
                # in place: the programs hold the caches' addresses
                for cache in self._caches:
                    for a in cache.values():
                        a.zero_()
            if self._prefix is not None:
                self._prefix.reset()
            if self._paged:
                self._pool.reset()
                self._page_table[:] = self._pool.scratch
                self._table_stale = True

    def _release(self, slot: int):
        """End a lease: drop its prefix read pin and, paged, its claim
        on every page it mapped (pages an entry or another slot still
        reads survive); returns the page ids that freed."""
        st = self._alloc.free(slot)
        if st.pinned is not None:
            self._prefix.unpin(st.pinned)
            st.pinned = None
        freed = []
        if self._paged:
            freed = self._pool.release(st.pages)
            st.pages = []
            self._page_table[slot, :] = self._pool.scratch
            self._table_stale = True
        return freed

    # ------------------------------------------------------------ admission
    def _admit(self, reqs):
        """Lease a slot per request; a prefix hit fills its matched
        positions now, so prefill only sees the suffix.  Paged: admit
        while a running budget of available pages covers the prompt and
        the first decode page; a blocked request and everything behind
        it go back to the front of the queue, in order."""
        now = time.monotonic()
        budget = self._pages_available() if self._paged else 0
        for i, req in enumerate(reqs):
            need = self._page_need(req) if self._paged else 0
            if self._paged and budget < need:
                self._count("page_faults")
                for r in reversed(reqs[i:]):
                    self._batcher.requeue(r)
                break
            budget -= need
            st = SlotState(req, req.prompt_len, req.max_new_tokens,
                           tokens=req.payload)
            st.t_schedule = now
            slot = self._alloc.alloc(st)
            self._count("admitted")
            self._count("prompt_tokens", req.prompt_len)
            if req.preempted:
                self._count("preempt_resumes")
            if self._prefix is not None and req.prompt_len > 1:
                self._prefix_admit(st, slot)

    def _pages_available(self) -> int:
        """Free pages plus what evicting every idle prefix entry would
        free: a cached prefix never blocks live work."""
        return self._pool.free_count + self._prefix.evictable_pages()

    def _page_need(self, req: Request) -> int:
        """The prompt plus the first decode page (a hit claims fewer)."""
        return self._pool.pages_for(min(req.prompt_len + 1,
                                        self.max_length))

    # --------------------------------------------------------- prefix cache
    def _prefix_admit(self, st: SlotState, slot: int):
        """Longest-prefix lookup, then the dense row copy or the paged
        page sharing.  At least one prompt token is left to prefill: its
        logits give the first token."""
        hit = self._prefix.lookup(st.request.payload)
        if hit is None:
            self._count("prefix_misses")
            return
        match, entry = hit
        match = min(match, st.prompt_len - 1)
        if match < self.prefix_min_tokens:
            self._count("prefix_misses")
            return
        if self._paged:
            self._prefix_admit_paged(st, slot, entry, match)
            return
        self._prefix.pin(entry)
        self._copy_rows(entry.row, slot, match)
        st.filled = match
        st.pinned = entry             # read-pinned until prefill completes
        self._count("prefix_hits")
        self._count("prefix_tokens_saved", match)

    def _prefix_admit_paged(self, st, slot, entry, match):
        """Share every whole matched page by refcount (read-only to this
        slot: its suffix starts past them) and copy a partial tail page
        into a fresh page of its own, int8 scales included."""
        ps = self.page_size
        match = min(match, entry.length)
        n_full = match // ps
        for i in range(n_full):
            pid = entry.pages[i]
            self._pool.ref(pid)
            st.pages.append(pid)
            self._page_table[slot, i] = pid
        self._table_stale = True
        filled = n_full * ps
        rem = match - filled
        if rem:
            self._prefix.pin(entry)   # the tail's source must survive
            newp = self._claim_pages(1)
            if newp is not None:
                self._copy_rows(entry.pages[n_full], newp[0], rem)
                st.pages.append(newp[0])
                self._page_table[slot, n_full] = newp[0]
                filled += rem
                st.pinned = entry
            else:
                self._count("page_faults")
                self._prefix.unpin(entry)
        if filled < self.prefix_min_tokens:
            # nothing usable shared: a plain miss
            self._pool.release(st.pages)
            st.pages = []
            self._page_table[slot, :] = self._pool.scratch
            self._count("prefix_misses")
            return
        st.filled = filled
        self._count("prefix_hits")
        self._count("prefix_tokens_saved", filled)

    def _prefix_insert(self, st: SlotState, slot: int):
        """A prefill just completed: cache the whole prompt."""
        if self._prefix is None or st.prompt_len < self.prefix_min_tokens:
            return
        self._pool_insert(st.tokens, slot, st.prompt_len, st)

    def _pool_insert(self, tokens, slot, length, st):
        """Dense: reserve a pool row (evicting the least recently used
        idle entry if none is free) and copy the slot's K/V ``[0,
        length)`` into it.  Paged: the entry takes refcounts on the
        slot's pages covering ``[0, length)``; a partial last page is
        shared too, since the donor writes only positions past
        ``length`` in it, which no reader reads."""
        if self._paged:
            npages = self._pool.pages_for(length)
            if npages > len(st.pages):
                return
            if self._prefix.insert(tokens, st.pages[:npages], length):
                self._count("prefix_inserts")
            return
        ev0 = self._prefix.evictions
        entry = self._prefix.insert(tokens)
        self._count("prefix_evictions", self._prefix.evictions - ev0)
        if entry is None:
            return
        self._copy_rows(slot, entry.row, length)
        self._count("prefix_inserts")

    # ---------------------------------------------------------- paged pages
    def _evict(self, k: int) -> int:
        """The pool's reclaim hook: evict idle prefix entries, least
        recently used first, until ``k`` pages freed."""
        ev0 = self._prefix.evictions
        freed = self._prefix.evict_pages(k)
        self._count("prefix_evictions", self._prefix.evictions - ev0)
        return freed

    def _claim_pages(self, n: int, reclaim: bool = True):
        """Allocate ``n`` pages, evicting idle prefix entries if the free
        list is short; ``reclaim=False`` (the speculation window's soft
        claim) takes the free list only."""
        return self._pool.alloc(n, self._evict if reclaim else None)

    def _ensure_pages(self, slot, st, upto) -> bool:
        """Grow ``slot``'s pages to cover positions ``[0, upto)``.  When
        the pool runs dry, idle prefix entries go first, then the
        youngest other slot is preempted by reference.  False when no
        victim is left: the caller preempts the slot itself."""
        need = self._pool.pages_for(upto) - len(st.pages)
        if need <= 0:
            return True
        pages = self._claim_pages(need)
        while pages is None:
            self._count("page_faults")
            victim = self._page_victim(slot)
            if victim is None:
                return False
            self._preempt(*victim)
            pages = self._claim_pages(need)
        base = len(st.pages)
        st.pages.extend(pages)
        self._page_table[slot, base:base + need] = pages
        self._table_stale = True
        return True

    def _page_victim(self, exclude):
        """The youngest admission holding pages, other than ``exclude``:
        the oldest work keeps running, which guarantees progress (every
        request fits the pool alone).  One priority class: the
        reference ranks by class first."""
        cands = [(slot, st) for slot, st in self._alloc.items()
                 if slot != exclude and st.pages]
        if not cands:
            return None
        # stable: among one admission batch the highest slot goes first
        cands.sort(key=lambda it: it[1].t_schedule)
        return cands[-1]

    def _grow_pages(self, finishing):
        """Before the cycle's launches, oldest admission first: every
        decoding slot, and every slot whose prefill ends this cycle,
        gets the page its next decode write needs (position ``pos``); a
        slot that cannot get one even after preempting others is
        preempted itself.  With speculation each also wants the window
        ``[pos, pos + k]``, as a soft claim from the free list: a
        shortfall never preempts, it degrades the cycle to plain decode,
        and claims past the accepted tokens are rewound after the
        verify."""
        self._spec_pages_ok = True
        ending = {slot for slot, _st in finishing}
        rows = [(slot, st) for slot, st in self._alloc.items()
                if not st.prefilling or slot in ending]
        rows.sort(key=lambda it: it[1].t_schedule)
        for slot, st in rows:
            if slot not in self._alloc:
                continue               # preempted as a victim already
            if not self._ensure_pages(slot, st, st.pos + 1):
                self._preempt(slot, st)
                continue
            if not self.spec_tokens:
                continue
            upto = min(st.pos + 1 + self.spec_tokens, self.max_length)
            need = self._pool.pages_for(upto) - len(st.pages)
            if need <= 0:
                continue
            pages = self._claim_pages(need, reclaim=False)
            if pages is None:
                self._spec_pages_ok = False
                continue
            base = len(st.pages)
            st.pages.extend(pages)
            self._page_table[slot, base:base + need] = pages
            self._table_stale = True

    def _scrub_pages(self, freed):
        """Zero freed pages in every layer (int8 scales too), so a page
        crossing tenants carries nothing of the last one."""
        if not freed or self._caches is None:
            return
        idx = self._dev(np.asarray(freed, np.int64))
        for cache in self._caches:
            for a in cache.values():
                a[idx] = 0

    def _rewind_pages(self, slot, st, scrub=True):
        """Release pages claimed past the slot's next write position
        (``st.pos``): the speculation window's claims beyond the
        accepted tokens.  After a verify wrote them, freed pages are
        scrubbed; a degraded cycle's claims were never written."""
        keep = self._pool.pages_for(st.pos + 1)
        if len(st.pages) <= keep:
            return
        tail = st.pages[keep:]
        del st.pages[keep:]
        self._page_table[slot, keep:keep + len(tail)] = self._pool.scratch
        self._table_stale = True
        freed = self._pool.release(tail)
        if freed:
            if scrub:
                self._scrub_pages(freed)
            self._count("spec_pages_rewound", len(freed))

    def _preempt(self, slot: int, st: SlotState):
        """Park a slot by reference: its progress (a decoding slot's K/V
        ``[0, pos)``, a prefilling one's ``[0, filled)``) becomes an
        evictable prefix entry, and its continuation — the prompt plus
        the tokens so far, the same future — requeues at the front and
        resumes by prefix hit."""
        req = st.request
        seq = np.concatenate([req.payload, np.asarray(st.generated,
                                                      np.int32)]) \
            if st.generated else req.payload
        park = st.filled if st.prefilling else st.pos
        if self._prefix is not None and park >= self.prefix_min_tokens:
            self._pool_insert(seq[:park], slot, park, st)
        self._release(slot)
        cont = Request(seq, st.max_new_tokens - len(st.generated),
                       req.eos_id, req.temperature, req.top_k, req.top_p,
                       req.seed)
        cont.future = req.future
        cont.t_submit = req.t_submit
        cont.t_first = req.t_first
        cont.preempted = req.preempted + 1
        self._batcher.requeue(cont)
        self._count("preemptions")
        # the continuation's completion counts only its own tokens
        self._count("tokens_generated", len(st.generated))

    # -------------------------------------------------------------- prefill
    def _plan_prefill(self):
        """Claim the pages of every prefilling slot's next chunk, then
        group: fresh prompts of at most ``prefill_chunk`` tokens take the
        full path by seq bucket; the rest (long prompts, suffixes behind
        a hit) at most one chunk batch, oldest admission first.  Returns
        (full groups, chunk rows, the rows whose prefill ends this
        cycle)."""
        ready = []
        for slot, st in self._alloc.items():
            if slot not in self._alloc or not st.prefilling:
                continue
            if self._paged:
                take = min(st.prompt_len - st.filled, self.prefill_chunk)
                if not self._ensure_pages(slot, st, st.filled + take):
                    self._preempt(slot, st)
                    continue
            ready.append((slot, st))
        full, chunked = {}, []
        for slot, st in ready:
            if slot not in self._alloc:
                continue               # preempted as a later slot's victim
            if st.filled == 0 and st.prompt_len <= self.prefill_chunk:
                full.setdefault(self.lattice.seq(st.prompt_len),
                                []).append((slot, st))
            else:
                chunked.append((slot, st))
        chunked.sort(key=lambda it: it[1].t_schedule)
        chunked = chunked[:self.lattice.max_batch]
        finishing = [r for rows in full.values() for r in rows] + [
            (slot, st) for slot, st in chunked
            if st.prompt_len - st.filled <= self.prefill_chunk]
        return full, chunked, finishing

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
            st.filled = st.prompt_len
            self._first_token(slot, st, int(first[i]))

    def _prefill_chunk_batch(self, rows):
        """One offset prefill over up to ``max_batch`` rows: row i writes
        its next ``min(remaining, prefill_chunk)`` prompt tokens behind
        its populated ``[0, filled)``."""
        take = [min(st.prompt_len - st.filled, self.prefill_chunk)
                for _s, st in rows]
        tb = self.lattice.seq(max(take))
        bb = self.lattice.batch(len(rows))
        toks = np.zeros((bb, tb), np.int32)
        lens = np.ones((bb,), np.int32)
        off = np.zeros((bb,), np.int32)
        sidx = np.full((bb,), self._alloc.scratch, np.int32)
        for i, (slot, st) in enumerate(rows):
            toks[i, :take[i]] = st.tokens[st.filled:st.filled + take[i]]
            lens[i] = take[i]
            off[i] = st.filled
            sidx[i] = slot
        self._count("padded_tokens", bb * tb - sum(take))
        self._count("prefill_chunks")
        first = self._run_prefill(
            toks, lens, sidx,
            self._samp_rows([st.request for _s, st in rows], bb), off=off)
        for i, (slot, st) in enumerate(rows):
            st.filled += take[i]
            if st.filled == st.prompt_len:
                self._first_token(slot, st, int(first[i]))

    def _first_token(self, slot: int, st: SlotState, token: int):
        """A prefill completed: release the read pin on its source
        entry, donate the prompt to the prefix cache, enter decode."""
        st.t_first = time.monotonic()
        if st.request.t_first is None:
            st.request.t_first = st.t_first
        if st.pinned is not None:
            self._prefix.unpin(st.pinned)
            st.pinned = None
        self._prefix_insert(st, slot)
        st.advance(token)
        self._finish_if_done(slot, st)

    # --------------------------------------------------------------- decode
    def _decode_rows(self):
        """The fixed-shape (S+1,) tokens, positions and sampling rows of
        a decode step, and the riding (slot, state) pairs.  Rows not
        decoding (free slots, the scratch row, slots mid-prefill) park
        at ``pos = Tmax``, so their writes land in the trash target."""
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
        return tok, pos, self._samp_rows(reqs, s1), riders

    def _decode_step(self):
        tok, pos, samp, riders = self._decode_rows()
        if self._paged and self.spec_tokens:
            # a plain cycle returns the soft window claims it will not use
            for slot, st in riders:
                self._rewind_pages(slot, st, scrub=False)
        self._count("decode_steps")
        nxt = self._run_decode(tok, pos, samp)
        for slot, st in riders:
            st.advance(int(nxt[slot]))
            self._finish_if_done(slot, st)

    def _spec_step(self):
        """One speculative cycle: draft, verify, then per slot accept the
        verify tokens while the drafts match them — the longest matching
        draft prefix plus one correction or bonus token, cut at the
        budget and at eos — so every accepted token is the one plain
        decode would give.  Rejected tokens rewind by not advancing; in
        the paged layout pages claimed past the accepted ones go back to
        the pool."""
        k = self.spec_tokens
        tok, pos, samp, riders = self._decode_rows()
        if all(st.remaining <= 1 for _s, st in riders):
            # every rider needs one more token: a window is overhead
            self._decode_step()
            return
        draft, vt = self._run_spec(tok, pos, samp)
        self._count("spec_cycles")
        n_prop = n_acc = 0
        for slot, st in riders:
            eos = st.request.eos_id
            n_prop += min(k, st.remaining)
            accepted = []
            for i in range(k + 1):
                if st.remaining - len(accepted) <= 0:
                    break
                t = int(vt[slot, i])
                accepted.append(t)
                matched = i < k and int(draft[slot, i]) == t
                n_acc += matched
                if (eos is not None and t == eos) or not matched:
                    break
            st.advance_many(accepted)
            if self._paged:
                self._rewind_pages(slot, st)
            self._finish_if_done(slot, st)
        self._count("spec_tokens_proposed", n_prop)
        self._count("spec_tokens_accepted", n_acc)

    def _finish_if_done(self, slot: int, st: SlotState):
        if st.done or (st.request.eos_id is not None
                       and st.last_token == st.request.eos_id):
            self._release(slot)
            self._complete(st)

    def _complete(self, st: SlotState):
        req = st.request
        now = time.monotonic()
        self._ttft.append(req.t_first - req.t_submit)
        self._latency.append(now - req.t_submit)
        self._count("completed")
        self._count("tokens_generated", len(st.generated))
        req.future.set_result(np.concatenate(
            [req.payload, np.asarray(st.generated, np.int32)]))
