"""`InferenceEngine` — the online serving front end (counterpart of
``mxnet_tpu/serving/engine.py``).

One background scheduler thread owns all device work; callers use
``submit()`` (returns an :class:`InferenceFuture`) or ``infer()``.  The
engine decodes a GPT-2 style LM (``prefill_slots``/``decode_step``) with
continuous batching over a persistent KV cache.  Each cycle sweeps
cancelled and expired requests, ticks the overload controller, lets an
``interactive`` arrival preempt a ``best_effort`` decode when every slot
is busy, admits queued requests into free slots (a prefix-cache hit
skips the matched positions), claims the pages the cycle will write,
prefills, then runs one fixed-shape decode step over every slot, free
ones parked at ``pos = Tmax`` — or, with ``spec_tokens``, one
speculative cycle.

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
writes.  When the pool runs dry the youngest admission of the lowest
class at or below the grower's is preempted by reference: its progress
becomes an evictable prefix entry, and its continuation requeues at the
front of its class with the same future and resumes by prefix hit.

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
prefix copy, the ``debug_parity`` twins, and the forward per batch
bucket.  On the card each is one CUDA graph, captured at its first call
and replayed after; ``warmup()`` captures the whole lattice, and after
it ``compiles`` stays where it is and every call counts a
``bucket_hit``.  On the CPU the same programs run their functions on
the same static buffers.  The private class attribute ``_graphs`` (an
instance may set it False before ``warmup()``) runs the programs
eagerly on the card: a comparison arm, never a fallback.

Overload control (:mod:`.overload`): requests carry a class
(``interactive`` / ``batch`` / ``best_effort``) and a deadline
(``timeout``), enforced while queued and mid-generation; with
``deadline_admission`` a deadline the phase-latency estimates already
overshoot is refused on arrival (:class:`DeadlineInfeasibleError`).  The
AIMD controller browns out under queue pressure and deadline misses —
non-interactive token budgets capped, prefix inserts paused, and only at
its floor the lowest class shed.  ``cancel()`` dequeues a request or
frees its slot and pages at the next cycle boundary.

Containment: ``guard_nonfinite`` (default on) fails a request whose
logits went NaN/Inf with :class:`NonFiniteOutputError`.  Every sampling
program (prefill, chunk, decode, verify) and the forward program returns
a per-row finite flag beside its tokens, in the same tensor, so it rides
the one host copy a cycle already makes.  The victim's pages are
scrubbed in place (or marked dirty and scrubbed at their next claim
while another reader holds them), a dense row is zeroed in place, the
int8 scale sidecar of its pages is scanned, and prefix entries over a
tainted page are dropped.  Fault sites fire where the reference's do
(``serving.scheduler`` outside the recovery net, ``serving.prefill`` /
``decode_step`` / ``forward`` / ``draft`` / ``verify`` before each
program call, with bounded retries of :class:`RetryableFault`; the
prefix and page sites; the ``serving.kv_scale`` and
``serving.draft_logits`` poisons, the latter a float32 input of the
draft program).  A watchdog condemns a dead or (with ``hang_timeout``)
hung scheduler and fails every rider with :class:`EngineCrashedError`;
it is suspended while a program compiles (a capture on the card).
``stop(drain=...)``, ``condemn()``, ``health()`` and
``install_signal_handlers()`` (SIGTERM drains) complete the lifecycle.

Observability: ``self.metrics`` is a :class:`~.metrics.ServingMetrics`
under the engine's claimed ``name`` (every counter, shed and served
count, phase histogram and span of the reference), the registry gauges
and the compile collector are the reference's, ``attach_exporter`` ties
a background exporter to ``stop()``, the tracer gets the request's
spans and events, the flight recorder its records and the live engine
in its bundles.  ``debug_parity`` runs a float32 gather-arm twin cache
beside a paged engine (the kernel arm stays the engine's): it shares
the page table, mirrors every cache write, and feeds each step's
max-abs logit delta to ``stats()["quantized_kv"]["error"]``.

Sharded decode (``mesh=``, ``mesh_axes=``): every rank of the mesh
builds the engine; the mesh's first rank schedules and broadcasts each
program call's plan, the others follow it on their own heads and, with
a slot axis, their own KV rows (:mod:`.sharded`).  The compile
accounting is by mesh point (``"2dev:tp=2"``).  Under gloo, whose
transport stages through the host, the programs run eagerly; under
NCCL (or a mesh of one rank) they are CUDA graphs as on one device.

Not in this slice: KV tiers and migration (``host_pool_bytes``,
``disk_tier_dir``, prefill/decode ``role``s, queue A7): the engine
refuses those arguments.  ``stats()``
carries the reference's sections and keeps the port's earlier
``counters`` (flat, with ``shed`` and ``rejected``), ``rates``,
``engine.device`` and ``latency``'s ``ttft``/``request`` percentiles.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import math
import signal as _signal
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from ..analysis.lockwitness import (named_condition as _named_condition,
                                    named_lock as _named_lock,
                                    note_blocking as _note_blocking)
from ..base import MXNetError, training_mode
from ..context import resolve_device
from ..models.transformer import copy_cache_rows
from ..observability.flightrecorder import active as _fr_active
from ..observability.trace import active as _trace_active
from ..ops.paged import KERNEL_HEAD_DIMS
from ..parallel.mesh import use_mesh
from ..resilience.faults import (RetryableFault, inject as _inject,
                                 poison as _poison)
from .batcher import BucketLattice, DynamicBatcher
from .errors import (DeadlineInfeasibleError, EngineCrashedError,
                     EngineStoppedError, InvalidRequestError,
                     NonFiniteOutputError, QueueFullError,
                     RequestCancelledError, RequestTimeoutError,
                     ServingError)
from .graphs import Program
from .kv_pages import PagedPrefixCache, PagePool
from .kv_slots import SlotAllocator, SlotState
from .metrics import ServingMetrics
from .overload import (PRIORITY_BATCH, PRIORITY_BEST_EFFORT,
                       PRIORITY_INTERACTIVE, OverloadController,
                       priority_name, priority_ordinal)
from .prefix_cache import PrefixCache
from .sampling import sample_tokens
from .sharded import BEAT, PROGRAMS, ServingMesh

__all__ = ["InferenceEngine", "InferenceFuture", "Request"]

_log = logging.getLogger(__name__)

# Live engines by metrics name: an engine's name is its identity in the
# process-wide registry (the ``engine=`` label of every mxtpu_serving_*
# series), so two live engines never share one.  Weak values: a
# collected engine releases its name.
_LIVE_NAMES = weakref.WeakValueDictionary()
_NAME_LOCK = _named_lock("serving.engine_names",
                         "process-wide live-engine name claims")


def _claim_engine_name(base: str, engine: "InferenceEngine") -> str:
    with _NAME_LOCK:
        name, i = base, 1
        while _LIVE_NAMES.get(name) is not None:
            i += 1
            name = f"{base}-{i}"
        _LIVE_NAMES[name] = engine
        return name


def _release_engine_name(engine: "InferenceEngine") -> None:
    """A stopped or condemned engine releases its name at once, so a
    successor under the same base reclaims the plain one."""
    with _NAME_LOCK:
        if _LIVE_NAMES.get(engine.name) is engine:
            del _LIVE_NAMES[engine.name]


class _NoSlots:
    """Forward mode's slot allocator: no KV slots, none in flight."""

    num_slots = free_count = active_count = active_highwater = 0

    @staticmethod
    def items():
        return []


class InferenceFuture:
    """Write-once result holder; safe across threads.  ``trace_id`` is
    the request's trace id (None with tracing off); ``t_done`` the
    ``time.monotonic()`` instant the engine resolved it."""

    __slots__ = ("_ev", "_result", "_exc", "trace_id", "t_done")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc = None
        self.trace_id = None
        self.t_done: Optional[float] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def set_result(self, value):
        if not self._ev.is_set():
            self._result = value
            self.t_done = time.monotonic()
            self._ev.set()

    def set_exception(self, exc: BaseException):
        if not self._ev.is_set():
            self._exc = exc
            self.t_done = time.monotonic()
            self._ev.set()

    def result(self, timeout: Optional[float] = None):
        _note_blocking("serving.future_wait")
        if not self._ev.wait(timeout):
            raise TimeoutError("result() wait timed out (the request may "
                               "still complete server-side)")
        if self._exc is not None:
            raise self._exc
        return self._result


class Request:
    __slots__ = ("id", "kind", "payload", "prompt_len", "max_new_tokens",
                 "eos_id", "deadline", "future", "t_submit", "t_enqueue",
                 "t_schedule", "t_first", "shape_key", "retries_left",
                 "trace_id", "priority", "preempted", "temperature",
                 "top_k", "top_p", "seed")

    _ids = itertools.count()

    def __init__(self, kind, payload, max_new_tokens=0, eos_id=None,
                 deadline=None, priority=PRIORITY_BATCH, temperature=0.0,
                 top_k=0, top_p=1.0, seed=0):
        self.retries_left = 0         # the engine grants the budget
        self.trace_id = None
        self.id = next(self._ids)
        self.kind = kind
        self.payload = payload
        self.prompt_len = int(payload.shape[0]) if kind == "decode" else 0
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline = deadline
        self.priority = priority       # ordinal into overload.PRIORITIES
        self.preempted = 0             # times preempted (slot reclaimed)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.future = InferenceFuture()
        self.t_submit = time.monotonic()
        self.t_enqueue = self.t_submit
        self.t_schedule = None
        self.t_first = None            # the first token, any run
        self.shape_key = (tuple(payload.shape), str(payload.dtype)) \
            if kind == "forward" else None

    @property
    def priority_name(self) -> str:
        return priority_name(self.priority)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


_MESH_POINT = "1dev"
# a plan's stand-in for a device input: the follower's own last output
_PREV = "<previous output>"


def _host(t):
    """A program's output on the host, as a numpy copy."""
    return t.cpu().numpy().copy()


def _percentiles(xs):
    if not xs:
        return {"count": 0, "p50": None, "p99": None, "mean": None}
    a = np.asarray(xs, dtype=np.float64)
    return {"count": int(a.size), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean())}


def _row_ok(logits):
    """(B,) int32, 1 where every value of row b is finite: reduced over
    every non-row axis, so (B, V) and (B, T, V) logits both give one
    flag a row."""
    return torch.isfinite(logits).flatten(1).all(dim=1).to(torch.int32)


class InferenceEngine:
    """Serve a GPT-2 style model online, or any block in forward mode.
    See the module docstring.

    ``mode`` is ``'decode'`` or ``'forward'``; None picks decode when
    the net has the decode surface (``prefill_slots``/``decode_step``)
    and forward otherwise.  Parameters follow the reference:
    ``max_batch``/``max_wait_us`` (a batch closes at ``max_batch``
    requests or when the oldest has waited ``max_wait_us``; default
    ``MAX_WAIT_US``), ``queue_depth`` (default ``QUEUE_DEPTH``; beyond
    it ``submit`` sheds with :class:`QueueFullError`),
    ``default_timeout`` (seconds, None = no deadline), ``num_slots``
    (decode concurrency, default ``max_batch``), ``max_length`` (KV
    length per slot, default the model's), ``batch_buckets``/
    ``seq_buckets`` (the lattice), ``eos_id``,
    ``default_max_new_tokens``, ``hang_timeout`` (seconds of stale
    scheduler heartbeat with work pending before the watchdog condemns
    the engine; None = dead-thread detection only),
    ``watchdog_interval``, ``max_request_retries``/``retry_backoff``
    (retryable step faults), ``guard_nonfinite``, ``prefix_pool_rows``
    (dense prefix-cache rows, 0 = off; ignored when paged),
    ``prefill_chunk`` (tokens per prefill call, default the largest seq
    bucket), ``prefix_min_tokens`` (the shortest prefix worth caching),
    ``prefix_fault_limit`` (consecutive faults at one ``serving.prefix_*``
    site before the cache is disabled), ``default_priority``,
    ``preemption``, ``deadline_admission``/``deadline_safety``/
    ``deadline_min_history``, ``brownout``/``overload_controller``,
    ``kv_layout``, ``page_size``, ``num_pages`` (default: the
    dense-equivalent ``num_slots * max_length / page_size``),
    ``kv_quant``, ``paged_attention``, ``debug_parity``, ``spec_tokens``
    (speculation depth k, 0 = off), ``draft_layers`` (the drafter's
    blocks, fewer than the model's) and ``name`` (the base of the
    engine's metrics name, uniquified against live engines).
    ``device`` is where the engine runs (default: the current CUDA
    device; raises without one): the model's parameters must already
    live there.  ``mesh`` is None, a device count (``make_mesh(dp=1,
    tp=N)`` over a job of N ranks) or a :class:`~mxnet_tpu_torch.parallel.
    Mesh`; ``mesh_axes`` names its model axis and an optional slot axis
    (module docstring, :mod:`.sharded`).  ``host_pool_bytes``/
    ``tier_fault_limit``/``disk_tier_dir``/``role`` (queue A7) are
    accepted only at their defaults.
    """

    QUEUE_DEPTH = 64
    MAX_WAIT_US = 2000.0
    # programs are CUDA graphs on the card; False runs them eagerly (a
    # comparison arm for the card and its tests, set before warmup())
    _graphs = True

    #: shed reason → the aggregate counter it stamps
    _SHED_COUNTER = {"queue_full": "rejected_queue_full",
                     "priority_shed": "rejected_queue_full",
                     "brownout": "rejected_queue_full",
                     "deadline_infeasible": "rejected_infeasible"}

    def __init__(self, net, mode: Optional[str] = None, *,
                 max_batch: int = 8,
                 max_wait_us: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 default_timeout: Optional[float] = None,
                 num_slots: Optional[int] = None,
                 max_length: Optional[int] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None,
                 default_max_new_tokens: int = 16,
                 hang_timeout: Optional[float] = None,
                 watchdog_interval: float = 0.1,
                 max_request_retries: int = 2,
                 retry_backoff: float = 0.01,
                 guard_nonfinite: bool = True,
                 prefix_pool_rows: int = 0,
                 prefill_chunk: Optional[int] = None,
                 prefix_min_tokens: int = 4,
                 prefix_fault_limit: int = 3,
                 default_priority: str = "batch",
                 preemption: bool = True,
                 deadline_admission: bool = True,
                 deadline_safety: float = 1.0,
                 deadline_min_history: int = 8,
                 brownout: bool = True,
                 overload_controller: Optional[OverloadController] = None,
                 kv_layout: str = "dense", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 paged_attention: Optional[str] = None,
                 debug_parity: bool = False,
                 host_pool_bytes: int = 0,
                 tier_fault_limit: int = 3,
                 disk_tier_dir: Optional[str] = None,
                 spec_tokens: int = 0, draft_layers: int = 1,
                 mesh=None, mesh_axes="tp", role: str = "unified",
                 name: str = "serving",
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
        if role not in ("prefill", "decode", "unified"):
            raise ServingError(f"role must be 'prefill'|'decode'|"
                               f"'unified', got {role!r}")
        if int(host_pool_bytes) < 0:
            raise ServingError(f"host_pool_bytes must be >= 0, got "
                               f"{host_pool_bytes}")
        if role != "unified" or int(host_pool_bytes) or \
                disk_tier_dir is not None or int(tier_fault_limit) != 3:
            raise MXNetError("role/host_pool_bytes/disk_tier_dir/"
                             "tier_fault_limit: disaggregated serving and "
                             "the tiered prefix cache are ROADMAP queue A7")
        self.mode = mode
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ServingError(f"the model's parameters live on "
                               f"{net.device}, the engine runs on "
                               f"{self.device}: initialize or load the "
                               "model on the engine's device")
        self.net = net
        self.max_batch = int(max_batch)
        if max_wait_us is not None:
            self.MAX_WAIT_US = float(max_wait_us)
        queue_depth = self.QUEUE_DEPTH if queue_depth is None \
            else int(queue_depth)
        self.default_timeout = default_timeout
        self.eos_id = eos_id
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.name = _claim_engine_name(str(name), self)
        self.metrics = ServingMetrics(self.name)
        self.role = role
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        # the programs by key, their shared memory pool and capture
        # stream (made at the first capture)
        self._programs = {}
        self._graph_pool = None
        self._graph_stream = None
        self._caches = None
        self._parity_caches = None
        self._table_dev = None
        # the port's raw per-request TTFT and latency (seconds), beside
        # the metrics' histograms: the scheduler appends, stats() reads
        self._ttft = []
        self._latency = []
        self._lat_lock = _named_lock("serving.metrics",
                                     "the engine's per-request latency "
                                     "lists")
        self.debug_parity = bool(debug_parity)
        if mode == "forward":
            if mesh is not None:
                raise ServingError(
                    "mesh= is a decode-mode knob — forward mode has no "
                    "sharded serving surface (shard the net's params with "
                    "parallel.shard_params instead)")
            self._init_forward(batch_buckets, spec_tokens, draft_layers,
                               kv_quant, paged_attention,
                               prefix_min_tokens)
        else:
            self._init_decode(net, num_slots, max_length, batch_buckets,
                              seq_buckets, prefix_pool_rows, prefill_chunk,
                              prefix_min_tokens, page_size, num_pages,
                              kv_quant, paged_attention, spec_tokens,
                              draft_layers, mesh is not None)
        if self.debug_parity:
            if not self._paged:
                raise ServingError("debug_parity compares against the "
                                   "float32 paged gather arm — it needs "
                                   "kv_layout='paged'")
            if self.spec_tokens or mesh is not None:
                raise ServingError(
                    "debug_parity is a single-engine debug knob: "
                    "incompatible with spec_tokens and mesh — those paths "
                    "write K/V the float32 twin cannot mirror")
        self._init_mesh(mesh, mesh_axes)
        # whether the sampling programs also return their raw logits for
        # the twin: fixed when the programs are built
        self._dbg = self.debug_parity
        self._dbg_logits = None
        self.prefix_fault_limit = int(prefix_fault_limit)
        # consecutive faults per site: a clean lookup runs before every
        # copy, so a shared streak could never trip on a failing copy
        self._prefix_faults = {"lookup": 0, "copy": 0}
        self._prefix_disabled = False
        self.guard_nonfinite = bool(guard_nonfinite)
        self.default_priority = priority_ordinal(default_priority)
        self.preemption = bool(preemption)
        self.deadline_admission = bool(deadline_admission)
        self.deadline_safety = float(deadline_safety)
        self.deadline_min_history = int(deadline_min_history)
        self._overload = overload_controller \
            if overload_controller is not None else \
            OverloadController(queue_depth, enabled=bool(brownout))
        self._cancels: set = set()     # futures flagged for slot reclaim
        self._timeouts_seen = 0        # the controller's miss delta
        self.hang_timeout = hang_timeout
        self.watchdog_interval = float(watchdog_interval)
        self.max_request_retries = int(max_request_retries)
        self.retry_backoff = float(retry_backoff)
        self._cond = _named_condition(
            "serving.engine.cond", "admission queue + scheduler wakeups")
        self._batcher = DynamicBatcher(queue_depth, cond=self._cond)
        self._step_lock = _named_lock(
            "serving.engine.step", "in-flight state vs stop()/watchdog")
        self._stop_lock = _named_lock(
            "serving.engine.stop", "stop()/condemn() mutual exclusion")
        self._thread: Optional[threading.Thread] = None
        self._watchdog = None
        self._heartbeat: Optional[float] = None
        self._compiling = False
        self._cycle_busy = False
        self._inflight_fwd = ()
        self._crashed: Optional[BaseException] = None
        self._prev_handlers = None
        self._stopping = False
        self._exporter = None
        # whether every decoding slot got pages for the whole speculation
        # window this cycle; a shortfall degrades the cycle to plain
        # decode rather than preempting for an optimization
        self._spec_pages_ok = True
        self._register_gauges()

    @property
    def max_wait_us(self) -> float:
        return self.MAX_WAIT_US

    def _init_forward(self, batch_buckets, spec_tokens, draft_layers,
                      kv_quant, paged_attention, prefix_min_tokens):
        if int(spec_tokens):
            raise ServingError("spec_tokens is a decode-mode knob "
                               "(forward mode has no decode loop to "
                               "speculate)")
        if kv_quant or paged_attention:
            raise ServingError("kv_quant/paged_attention pick the paged "
                               "KV arm; forward mode has no KV cache")
        self.lattice = BucketLattice(batch_buckets, (1,),
                                     max_batch=self.max_batch)
        # no KV state: an allocator with no slots and no caches, so
        # the scheduler, failure and stats paths run unguarded
        self.max_length = None
        self.num_slots = 0
        self._alloc = _NoSlots()
        self._caches = ()
        self.prefix_pool_rows = 0
        self.prefill_chunk = None
        self.prefix_min_tokens = int(prefix_min_tokens)
        self.kv_quant = self.paged_attention = self.page_size = None
        self._paged_kernel = False
        self.num_pages = 0
        self._pool = self._prefix = None
        self.spec_tokens = 0
        self.draft_layers = int(draft_layers)

    def _init_mesh(self, mesh, mesh_axes):
        """The reference's mesh attributes, and the :class:`ServingMesh`
        (validation, this rank's shadow net, the plan exchange) when
        ``mesh`` is given.  ``self._model`` is what the programs run:
        the net, or its shadow over this rank's blocks."""
        self._mesh = ServingMesh(self, mesh, mesh_axes) \
            if mesh is not None else None
        m = self._mesh
        self.mesh = m.mesh if m is not None else None
        self.mesh_axes = m.axes if m is not None else ()
        self.mesh_devices = int(m.mesh.size) if m is not None else 1
        self._model_axis = m.model_axis if m is not None else None
        self._slot_axis = m.slot_axis if m is not None else None
        self._mesh_key = m.key if m is not None else _MESH_POINT
        self._model = m.shadow if m is not None else self.net
        # followers only: warmup() runs on every rank in step, no plans
        self._lockstep = False

    def _init_decode(self, net, num_slots, max_length, batch_buckets,
                     seq_buckets, prefix_pool_rows, prefill_chunk,
                     prefix_min_tokens, page_size, num_pages, kv_quant,
                     paged_attention, spec_tokens, draft_layers, meshed):
        self.max_length = int(max_length or net.max_length)
        if self.max_length > net.max_length:
            raise ServingError(
                f"max_length={self.max_length} exceeds the model's position "
                f"table (net.max_length={net.max_length})")
        self.num_slots = int(num_slots or self.max_batch)
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
        if paged_attention == "kernel" and meshed:
            raise ServingError(
                "paged_attention='kernel' does not compose with a serving "
                "mesh (the reference's paged kernel is not partitionable, "
                "and the port keeps its refusal); use the 'gather' arm "
                "under mesh")
        self.kv_quant = kv_quant
        self.paged_attention = (paged_attention or
                                ("gather" if meshed else "kernel")) \
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

    # ----------------------------------------------------------- the gauges
    def _register_gauges(self):
        """The reference's gauges and compile collector in the
        process-wide registry, bound by weak reference (a collected
        engine drops out of the next scrape).  None of them touches the
        device: a scrape may run during a capture."""
        from ..observability.registry import default_registry
        reg = default_registry()
        ref = weakref.ref(self)

        def bound(fn):
            def sample():
                eng = ref()
                if eng is None:
                    raise ReferenceError("engine collected")
                return fn(eng)
            return sample

        def kv_bytes_per_token(e):
            # cache bytes (scale sidecars included) over the positions
            # the layout holds; 0 until the caches exist
            if not e._caches:
                return 0.0
            leaves = [a for layer in e._caches for a in layer.values()]
            total = sum(a.numel() * a.element_size() for a in leaves)
            positions = int(leaves[0].shape[0]) * int(leaves[0].shape[1])
            return total / positions if positions else 0.0

        def accept_rate(e):
            c = e.metrics.counters
            p = c["spec_tokens_proposed"]
            return c["spec_tokens_accepted"] / p if p else 0.0

        def pool(attr):
            return lambda e: getattr(e._pool, attr) \
                if e._pool is not None else 0

        gauges = (
            ("mxtpu_serving_queue_depth",
             "requests waiting in the admission queue",
             lambda e: len(e._batcher)),
            ("mxtpu_serving_queue_depth_highwater",
             "deepest the admission queue has been (capacity-planning: "
             "distance to shedding)",
             lambda e: e._batcher.depth_highwater),
            ("mxtpu_serving_active_slots", "KV cache slots currently leased",
             lambda e: e._alloc.active_count),
            ("mxtpu_serving_num_slots",
             "decode concurrency (total KV cache slots)",
             lambda e: e.num_slots),
            ("mxtpu_serving_compile_cache_entries",
             "distinct compiled program shapes seen",
             lambda e: e.metrics.counters["compiles"]),
            ("mxtpu_serving_bucket_lattice_points",
             "size of the (batch, seq) shape-bucket lattice — the upper "
             "bound on compiles",
             lambda e: len(e.lattice)),
            ("mxtpu_serving_prefix_entries",
             "live prefix-cache radix-tree entries",
             lambda e: len(e._prefix) if e._prefix is not None else 0),
            ("mxtpu_serving_kv_pages_total",
             "paged-KV page pool capacity (0 = dense layout)",
             pool("num_pages")),
            ("mxtpu_serving_kv_pages_free", "paged-KV pages on the free list",
             pool("free_count")),
            ("mxtpu_serving_kv_pages_shared",
             "paged-KV pages with >= 2 readers (prefix sharing / "
             "park-by-reference — each would be a duplicated row under "
             "the dense layout)",
             pool("shared_count")),
            ("mxtpu_serving_kv_bytes_per_token",
             "KV cache bytes (scale sidecars included) per token position "
             "of the layout — the quantized-KV density signal (0 = caches "
             "not built yet)",
             kv_bytes_per_token),
            ("mxtpu_serving_tier_host_bytes",
             "host-RAM bytes held by the tiered prefix cache's demoted KV "
             "bundles (0 = tier off)",
             lambda e: 0),
            ("mxtpu_serving_tier_entries",
             "demoted KV bundles resident in the host (and disk) tier",
             lambda e: 0),
            ("mxtpu_serving_tier_disabled",
             "1 once the tier self-disabled after its fault limit (the "
             "engine serves from HBM only)",
             lambda e: 0),
            ("mxtpu_serving_mesh_devices",
             "devices the engine's compiled programs span (1 = unsharded "
             "single-device serving)",
             lambda e: e.mesh_devices),
            ("mxtpu_serving_overload_factor",
             "brownout degradation factor (1.0 = normal; lower = "
             "non-interactive token budgets capped at this fraction)",
             lambda e: e._overload.factor),
            ("mxtpu_serving_brownout",
             "1 while the overload controller is in brownout",
             lambda e: 1 if e._overload.brownout else 0),
            ("mxtpu_serving_spec_draft_tokens",
             "speculative draft depth k (0 = speculation off)",
             lambda e: e.spec_tokens),
            ("mxtpu_serving_spec_acceptance_rate",
             "accepted / proposed draft tokens — the drafter-quality "
             "signal (the per-cycle bonus token is not counted as "
             "proposed)",
             accept_rate),
        )
        lbl = {"engine": self.metrics.name}
        for gname, ghelp, fn in gauges:
            reg.gauge(gname, help=ghelp, fn=bound(fn), **lbl)

        def compile_samples():
            eng = ref()
            if eng is None:
                raise ReferenceError("engine collected")
            n = eng.metrics.counters["compiles"]
            return [{"name": "mxtpu_serving_compiles", "kind": "gauge",
                     "labels": {"engine": eng.metrics.name,
                                "mesh_point": eng._mesh_key},
                     "value": n,
                     "help": "compiles at this (engine, mesh point) — "
                             "frozen after warmup()"}] if n else []

        reg.register_collector(
            f"serving-compiles:{self.metrics.name}", compile_samples)

    def attach_exporter(self, exporter) -> "InferenceEngine":
        """Tie a :class:`~mxnet_tpu_torch.observability.BackgroundExporter`
        to this engine's lifecycle: started here (if not already) and
        drained — final flush and join — by ``stop()``, the SIGTERM path
        included.  Returns ``self``."""
        self._exporter = exporter
        if exporter.ident is None:
            exporter.start()
        return self

    # ------------------------------------------------------------- lifecycle
    def start(self):
        """Start the scheduler.  On a mesh's follower rank this runs the
        loop that follows rank 0's plans, and returns when rank 0 stops
        (:mod:`.sharded`)."""
        if self._thread is not None:
            raise ServingError("engine already started")
        if self._batcher.closed:
            raise ServingError("engine cannot be restarted once stopped — "
                               "build a fresh InferenceEngine")
        if self._follower:
            self._follow()
            return self
        from ..resilience.watchdog import Watchdog
        self._heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name="mxnet_tpu_torch-serving",
                                        daemon=True)
        self._thread.start()
        self._watchdog = Watchdog(self._watchdog_check, self._watchdog_trip,
                                  interval=self.watchdog_interval,
                                  name="mxnet_tpu_torch-serving-watchdog")
        self._watchdog.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the engine.  ``drain=True`` finishes everything queued
        and in flight first; ``drain=False`` fails pending and in-flight
        requests with :class:`EngineStoppedError` at once.  Either way
        nothing is dropped silently: a request still held once the
        scheduler is down (crashed scheduler, an engine never started)
        fails typed.  Concurrent calls serialize (the SIGTERM handler's
        drain thread may race an explicit stop); if a bounded
        ``timeout`` expires mid-drain the engine is left running and a
        :class:`ServingError` is raised.  A stopped engine releases its
        compiled programs and their graphs."""
        with self._stop_lock:
            self._stop_locked(drain, timeout)

    def _stop_locked(self, drain: bool, timeout: Optional[float]):
        self._batcher.close()
        if not drain and self._crashed is None:
            # a hung scheduler holds _step_lock mid-step: the bounded
            # acquire keeps stop() from deadlocking on it
            got = self._step_lock.acquire(timeout=1.0)
            try:
                exc = EngineStoppedError("engine stopped without drain")
                for req in self._batcher.drain():
                    self._fail(req, exc)
                if got:
                    for slot, st in list(self._alloc.items()):
                        self._alloc.free(slot)
                        self._fail(st.request, exc)
                    for req in self._inflight_fwd:
                        self._fail(req, exc)
                else:
                    for req in self._snapshot_inflight_requests():
                        self._fail(req, exc)
            finally:
                if got:
                    self._step_lock.release()
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            if timeout is None:
                # unbounded, but a condemnation landing mid-join (a hung
                # scheduler) ends the wait after a short grace
                while t.is_alive() and self._crashed is None:
                    t.join(0.5)
                if t.is_alive():
                    t.join(2.0)
            else:
                t.join(timeout)
            if t.is_alive() and self._crashed is None:
                self.uninstall_signal_handlers()
                raise ServingError(
                    f"scheduler thread still draining after {timeout}s — "
                    "engine left running; call stop() again to keep "
                    "waiting")
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        exc = self._crashed or EngineStoppedError(
            "engine stopped — request was never scheduled")
        for req in self._batcher.drain():
            self._fail(req, exc)
        alive = t is not None and t.is_alive()
        if not alive:
            for slot, st in list(self._alloc.items()):
                self._alloc.free(slot)
                self._fail(st.request, exc)
            # a stopped engine never runs again: its graphs and their
            # pool go now, not whenever a collection breaks the cycle
            # through the programs' bound methods
            with self._step_lock:
                self._programs.clear()
                self._graph_pool = self._graph_stream = None
        self._thread = None
        self.uninstall_signal_handlers()
        # the exporter's final flush sees the terminal counters
        exp = self._exporter
        if exp is not None:
            self._exporter = None
            try:
                exp.stop(flush=True)
            except Exception:
                pass
        _release_engine_name(self)

    # ------------------------------------------------------------- watchdog
    def _watchdog_check(self) -> Optional[str]:
        if self._crashed is not None:
            return None
        t = self._thread
        if t is None:
            return None
        if not t.is_alive():
            # after a requested stop a dead thread is a normal exit
            return None if self._stopping else "scheduler thread died"
        if self.hang_timeout is not None and self._heartbeat is not None \
                and not self._compiling:
            age = time.monotonic() - self._heartbeat
            # _cycle_busy covers a popped forward batch, which lives in
            # neither the queue nor the slot allocator
            busy = (not self._batcher.empty() or self._cycle_busy
                    or self._alloc.active_count > 0)
            if busy and age > self.hang_timeout:
                return (f"scheduler heartbeat stale for {age:.2f}s "
                        f"(hang_timeout={self.hang_timeout}s) with work "
                        "pending")
        return None

    def _snapshot_inflight_requests(self):
        """Requests riding the scheduler, readable from other threads:
        slot leases plus a popped forward batch."""
        fwd = list(self._inflight_fwd)
        for _ in range(10):
            try:
                return fwd + [st.request for _s, st in self._alloc.items()]
            except RuntimeError:
                time.sleep(0.005)
        return fwd

    def _watchdog_trip(self, reason: str):
        """Condemn the engine: fail every queued and in-flight request.
        Runs on the watchdog thread, never blocks on the scheduler and
        never touches the device."""
        exc = EngineCrashedError(
            f"serving scheduler failed: {reason} — all pending requests "
            "failed; build a fresh InferenceEngine", engine=self.name)
        self._crashed = exc
        self.metrics.count("watchdog_trips")
        self.metrics.mark("watchdog_trip")
        fr = _fr_active()
        if fr is not None:
            fr.trigger("serving.crash", engine=self.name, reason=reason)
        self._batcher.close()
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for req in self._batcher.drain():
            self._fail(req, exc)
        for req in self._snapshot_inflight_requests():
            self._fail(req, exc)
        _release_engine_name(self)

    def condemn(self, reason: str):
        """Condemn the engine from outside (a router's force-stop): as a
        watchdog trip, every queued and in-flight request fails with
        :class:`EngineCrashedError` and the engine cannot serve again.
        Any thread; never blocks on the scheduler."""
        self._watchdog_trip(f"condemned: {reason}")

    def health(self) -> dict:
        """Liveness and readiness for external probes: ``live`` while
        the scheduler runs uncondemned, ``ready`` while it also accepts
        work."""
        t = self._thread
        alive = t is not None and t.is_alive()
        live = alive and self._crashed is None
        hb_age = None if self._heartbeat is None else \
            round(time.monotonic() - self._heartbeat, 4)
        c = self.metrics.counters
        return {
            "name": self.name,
            "live": live,
            "ready": live and not self._stopping
            and not self._batcher.closed,
            "crashed": None if self._crashed is None else str(self._crashed),
            "heartbeat_age_s": hb_age,
            "queued": len(self._batcher),
            "active_slots": self._alloc.active_count,
            "retries": c["retries"],
            "watchdog_trips": c["watchdog_trips"],
        }

    def install_signal_handlers(self, signals=(_signal.SIGTERM,)):
        """Route ``signals`` (default SIGTERM, the preemption notice) to
        a graceful ``stop(drain=True)`` on a helper thread.  Main thread
        only; returns the previous handlers (restored by
        ``uninstall_signal_handlers()`` and ``stop()``)."""
        prev = {}
        for s in signals:
            prev[s] = _signal.signal(s, self._on_term_signal)
        self._prev_handlers = prev
        return prev

    def uninstall_signal_handlers(self):
        # restoring is main-thread-only: a stop on the drain thread keeps
        # them for a later main-thread call
        if self._prev_handlers and \
                threading.current_thread() is threading.main_thread():
            for s, h in self._prev_handlers.items():
                try:
                    _signal.signal(s, h)
                except (ValueError, TypeError):
                    pass
            self._prev_handlers = None

    def _on_term_signal(self, signum, frame):
        # never drain inside a signal handler (the interrupted frame may
        # hold the locks a drain and the flight bundle need)
        def _drain():
            fr = _fr_active()
            if fr is not None:
                fr.trigger("signal.sigterm", engine=self.name,
                           signum=signum)
            self.stop(drain=True)

        threading.Thread(target=_drain, name="mxnet_tpu_torch-serving-drain",
                         daemon=True).start()

    def __enter__(self):
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    # ---------------------------------------------------------------- submit
    def _reject(self, reason: str, exc: BaseException, *,
                priority: Optional[str] = None, trace_id=None,
                request_id=None):
        """The one audited rejection path out of ``submit()``: every
        rejection stamps exactly one aggregate counter, one shed sample
        (shed reasons only) and one trace event, then raises ``exc``."""
        counter = self._SHED_COUNTER.get(reason)
        if counter is not None:
            self.metrics.count(counter)
            self.metrics.count_shed(reason, priority or "unknown")
            self.metrics.mark("shed")
            event = "serving.shed"
        else:
            self.metrics.count("rejected_invalid" if reason == "invalid"
                               else "rejected_crashed")
            event = "serving.reject"
        tr = _trace_active()
        if tr is not None:
            tr.event(event, trace_id=trace_id, reason=reason,
                     request=request_id)
        fr = _fr_active()
        if fr is not None:
            fr.record(event, engine=self.name, reason=reason,
                      priority=priority, request=request_id,
                      trace_id=trace_id)
        raise exc

    def _shed_queued(self, victim: Request, reason: str):
        """Fail a queued request evicted by a higher-class arrival: the
        audit of :meth:`_reject`, the typed error on the victim's
        future."""
        self.metrics.count(self._SHED_COUNTER[reason])
        self.metrics.count_shed(reason, victim.priority_name)
        self.metrics.mark("shed")
        tr = _trace_active()
        if tr is not None:
            tr.event("serving.shed", trace_id=victim.trace_id,
                     reason=reason, request=victim.id)
        fr = _fr_active()
        if fr is not None:
            fr.record("serving.shed", engine=self.name, reason=reason,
                      priority=victim.priority_name, request=victim.id,
                      trace_id=victim.trace_id)
        victim.future.set_exception(QueueFullError(
            f"request {victim.id} ({victim.priority_name}) evicted from "
            f"the queue by higher-priority arrival ({reason})"))

    def _brownout_shed_or_admit(self, pr: int, now: float):
        """At the controller's floor the lowest class sheds on arrival;
        everything milder is degradation, not refusal."""
        if self._overload.shedding(pr, now):
            self._reject("brownout", QueueFullError(
                f"engine in brownout at floor — shedding "
                f"{priority_name(pr)} arrivals"), priority=priority_name(pr))

    def _feasible_or_reject(self, pr: int, mnt: int, deadline: float,
                            now: float):
        """Deadline-aware admission: queue wait (behind same-or-higher
        class work) plus prefill and per-token decode time from the
        phase histograms; a deadline the estimate overshoots is refused
        on arrival.  Engages once ``deadline_min_history`` completions
        exist; a fault at ``overload.admission`` admits."""
        est = self.metrics.latency_estimates(self.deadline_min_history)
        if est is None:
            return
        try:
            _inject("overload.admission")
        except Exception:
            self.metrics.count("overload_faults")
            return
        prefill_p50, per_token, service_p50 = est
        ahead = self._batcher.depth_at_or_above(pr)
        waves = ahead / max(1, self.num_slots)
        need = (waves * service_p50 + prefill_p50
                + per_token * mnt) * self.deadline_safety
        if now + need > deadline:
            self._reject("deadline_infeasible", DeadlineInfeasibleError(
                f"deadline infeasible on arrival: estimated "
                f"{need * 1e3:.1f}ms (queue {ahead} ahead at class, "
                f"{mnt} tokens) exceeds the {(deadline - now) * 1e3:.1f}"
                f"ms remaining"), priority=priority_name(pr))

    def submit(self, x, max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None,
               eos_id: Optional[int] = None,
               priority: Optional[str] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0) -> InferenceFuture:
        """Enqueue one request; returns its future.  Decode mode: ``x``
        is one prompt (1-D ints, or (1, T)) and the result the full
        sequence (prompt + generated) as np.int32; prompts longer than
        the largest seq bucket prefill in chunks, and prompt +
        ``max_new_tokens`` must fit ``max_length``.  ``temperature <= 0``
        (the default) is exact greedy argmax; otherwise the request
        samples with its own seeded noise.  Forward mode: ``x`` is ONE
        example without the batch dim, and the result is the block's
        output row (a tuple of rows for a block with several outputs)
        as numpy.  ``timeout`` is the server-side deadline in seconds
        (None/0 = none), enforced while queued and mid-generation and,
        with ``deadline_admission``, on arrival.  ``priority`` is the
        request's class (default ``default_priority``)."""
        if self._follower:
            raise ServingError(
                f"submit on rank {self._mesh.leader_rank} of the mesh: it "
                "schedules the engine, and the other ranks follow its plans")
        try:
            pr = self.default_priority if priority is None \
                else priority_ordinal(priority)
        except ServingError as e:
            self._reject("invalid", InvalidRequestError(str(e)))
        if self._crashed is not None:
            self._reject("crashed",
                         EngineCrashedError(str(self._crashed),
                                            engine=self.name),
                         priority=priority_name(pr))
        timeout = self.default_timeout if timeout is None else timeout
        now = time.monotonic()
        deadline = now + timeout if timeout else None
        if self.mode == "forward":
            if temperature or top_k or top_p != 1.0 or seed:
                self._reject("invalid", InvalidRequestError(
                    "sampling parameters (temperature/top_k/top_p/seed) "
                    "are a decode-mode surface — a forward request has no "
                    "token distribution to sample"),
                    priority=priority_name(pr))
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            arr = np.array(x)
            self.metrics.count("submitted")
            self._brownout_shed_or_admit(pr, now)
            req = Request("forward", arr, deadline=deadline, priority=pr)
        else:
            if not (math.isfinite(float(temperature))
                    and float(temperature) >= 0.0) or int(top_k) < 0 \
                    or not 0.0 < float(top_p) <= 1.0:
                self._reject("invalid", InvalidRequestError(
                    f"bad sampling params: need temperature >= 0 (finite), "
                    f"top_k >= 0, 0 < top_p <= 1 — got temperature="
                    f"{temperature}, top_k={top_k}, top_p={top_p}"),
                    priority=priority_name(pr))
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            arr = np.asarray(x, dtype=np.int32)
            if arr.ndim == 2 and arr.shape[0] == 1:
                arr = arr[0]
            if arr.ndim != 1:
                self._reject("invalid", InvalidRequestError(
                    f"a decode request is ONE prompt: expected shape (T,) "
                    f"or (1, T), got {arr.shape}"),
                    priority=priority_name(pr))
            mnt = int(self.default_max_new_tokens if max_new_tokens is None
                      else max_new_tokens)
            if arr.size < 1 or mnt < 1:
                self._reject("invalid", InvalidRequestError(
                    f"need a non-empty prompt and max_new_tokens >= 1 (got "
                    f"len={arr.size}, max_new_tokens={mnt})"),
                    priority=priority_name(pr))
            if arr.size + mnt > self.max_length:
                self._reject("invalid", InvalidRequestError(
                    f"prompt len {arr.size} + {mnt} new tokens does not "
                    f"fit the KV length ({self.max_length})"),
                    priority=priority_name(pr))
            # every valid request counts submitted before the overload
            # gates, so every shed reason shares one denominator
            self.metrics.count("submitted")
            self._brownout_shed_or_admit(pr, now)
            mnt = self._overload.cap_tokens(pr, mnt)
            if deadline is not None and self.deadline_admission:
                self._feasible_or_reject(pr, mnt, deadline, now)
            req = Request("decode", arr.copy(), mnt,
                          self.eos_id if eos_id is None else eos_id,
                          deadline, priority=pr, temperature=temperature,
                          top_k=top_k, top_p=top_p, seed=seed)
        req.retries_left = self.max_request_retries
        tr = _trace_active()
        if tr is not None:
            req.trace_id = req.future.trace_id = tr.new_trace_id()
            tr.event("serving.submit", trace_id=req.trace_id,
                     request=req.id, kind=req.kind,
                     priority=req.priority_name)
        fr = _fr_active()
        if fr is not None:
            fr.record("serving.submit", engine=self.name, request=req.id,
                      kind=req.kind, priority=req.priority_name,
                      trace_id=req.trace_id)
        try:
            victim = self._batcher.put(req)
        except QueueFullError as e:
            self._reject("queue_full", e, priority=priority_name(pr),
                         trace_id=req.trace_id, request_id=req.id)
        if victim is not None:
            self._shed_queued(victim, "priority_shed")
        return req.future

    def cancel(self, fut: InferenceFuture) -> bool:
        """Cancel a submitted request: a queued one is dequeued and
        fails with :class:`RequestCancelledError`; a mid-decode one is
        flagged, and the scheduler frees its slot and pages at the next
        cycle boundary.  True iff a live request was found.  Any
        thread.  Forward mode cancels only queued requests (a popped
        batch resolves within its cycle)."""
        req = self._batcher.remove(fut)
        if req is not None:
            self._fail(req, RequestCancelledError(
                f"request {req.id} cancelled while queued"))
            return True
        if fut.done() or self.mode == "forward":
            return False
        for r in self._snapshot_inflight_requests():
            if r.future is fut:
                with self._cond:
                    self._cancels.add(fut)
                    self._cond.notify_all()
                return True
        return False

    def force_brownout(self, reason: str = "external") -> None:
        """Slam the overload controller to its floor (a router's
        coordinated brownout); recovery is automatic.  Any thread."""
        was = self._overload.brownout
        self._overload.force()
        if not was and self._overload.brownout:
            self.metrics.count("brownouts")
            self.metrics.mark("brownout", reason)
            fr = _fr_active()
            if fr is not None:
                fr.record("serving.brownout", engine=self.name,
                          reason=reason)

    def coordinate_overload(self, factor_cap: Optional[float] = None,
                            deadline_safety: Optional[float] = None
                            ) -> None:
        """An external controller with aggregate visibility caps the
        brownout factor (the effective factor is ``min(local, cap)``)
        and sets the deadline-admission safety margin.  Any thread."""
        if factor_cap is not None:
            if self._overload.set_fleet_cap(factor_cap):
                self.metrics.count("brownouts")
                self.metrics.mark("brownout", "fleet_coordinated")
                fr = _fr_active()
                if fr is not None:
                    fr.record("serving.brownout", engine=self.name,
                              reason="fleet_coordinated")
        if deadline_safety is not None:
            if deadline_safety <= 0:
                raise ServingError(
                    f"deadline_safety must be > 0, got {deadline_safety}")
            self.deadline_safety = float(deadline_safety)

    def infer(self, x, max_new_tokens: Optional[int] = None,
              timeout: Optional[float] = None,
              eos_id: Optional[int] = None,
              priority: Optional[str] = None, temperature: float = 0.0,
              top_k: int = 0, top_p: float = 1.0, seed: int = 0):
        """Synchronous ``submit()`` + wait.  ``timeout`` is the server's
        deadline; the wait itself is unbounded (the scheduler resolves
        every future)."""
        if self._thread is None:
            raise ServingError("engine not started — call start() or use "
                               "the context manager")
        return self.submit(x, max_new_tokens, timeout, eos_id, priority,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed).result(None)

    # ---------------------------------------------------------------- warmup
    def warmup(self, example_shape: Optional[Sequence[int]] = None,
               dtype: str = "float32") -> int:
        """Compile the whole lattice, so that no request pays a capture
        and ``compiles`` stays where it is afterwards.  Decode mode: the
        decode step, every (batch, seq) point of the full and the chunk
        prefill lattices (capped at the ``prefill_chunk`` bucket), with
        speculation the draft and the verify window, with a prefix
        cache the row copy (one program: src, dst and length are device
        scalars), and with ``debug_parity`` the twin of each, each run
        once on scratch rows.  Forward mode: one forward per batch
        bucket for examples of ``example_shape`` (no batch dim) and
        ``dtype``.  Needs an idle engine; returns the number of programs
        compiled, as the reference's does."""
        with self._step_lock, self._in_step():
            before = self.metrics.counters["compiles"]
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
                return self.metrics.counters["compiles"] - before
            if self._alloc.active_count:
                raise ServingError("warmup needs an idle engine")
            s1 = self.num_slots + 1
            scratch = self._alloc.scratch
            self._sync_table()
            idle_tok = np.zeros((s1,), np.int32)
            idle_pos = np.full((s1,), self.max_length, np.int32)
            self._run_decode(idle_tok, idle_pos, self._samp_rows([], s1))
            self._parity("decode", (idle_tok, idle_pos), [])
            if self.spec_tokens:
                self._run_spec(idle_tok, idle_pos, self._samp_rows([], s1))
            for bb, tb in self.lattice.prefill_points(self.prefill_chunk):
                args = (np.zeros((bb, tb), np.int32), np.ones((bb,), np.int32),
                        np.full((bb,), scratch, np.int32))
                off = np.zeros((bb,), np.int32)
                self._run_prefill(*args, self._samp_rows([], bb))
                self._parity("prefill", args, [])
                self._run_prefill(*args, self._samp_rows([], bb), off=off)
                self._parity("chunk", args + (off,), [])
            if self._prefix is not None:
                # the paged layout's tail-page copy: the zero page onto
                # itself, length 0
                scr = self._pool.scratch if self._paged else scratch
                self._copy_rows(scr, scr, 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return self.metrics.counters["compiles"] - before

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The reference's sections (``requests``, ``batches``,
        ``tokens``, ``compile_cache``, ``prefix_cache``, ``ttft``,
        ``speculative``, ``migration``, ``tier``, ``overload`` with the
        controller, ``quantized_kv``, ``resilience``, ``latency``,
        ``engine``, ``slots``, ``mesh``, ``compile``), and the port's
        ``counters`` (every counter, flat, plus ``shed``: queue-full,
        priority and brownout sheds, and ``rejected``: invalid
        requests), ``rates``, ``engine.device`` and ``latency``'s
        ``ttft``/``request`` percentiles.  Host state only."""
        s = self.metrics.stats()
        c = dict(self.metrics.counters)
        s["engine"] = {
            "name": self.name,
            "device": str(self.device),
            "mode": self.mode,
            "queued": len(self._batcher),
            "active_slots": self._alloc.active_count,
            "num_slots": self.num_slots,
            "batch_buckets": list(self.lattice.batch_buckets),
            "seq_buckets": list(self.lattice.seq_buckets)
            if self.mode == "decode" else None,
            "prefill_chunk": self.prefill_chunk,
            "prefix_pool_rows": self.prefix_pool_rows,
            "prefix_entries": len(self._prefix)
            if self._prefix is not None else 0,
            "prefix_disabled": self._prefix_disabled,
            "running": self._thread is not None,
            "crashed": self._crashed is not None,
            "default_priority": priority_name(self.default_priority),
            "preemption": self.preemption,
            "deadline_admission": self.deadline_admission,
            "spec_tokens": self.spec_tokens,
            "draft_layers": self.draft_layers,
            "role": self.role,
            "migrate_target": False,
        }
        s["slots"] = {
            "kv_layout": self.kv_layout,
            "num_slots": self.num_slots,
            "active": self._alloc.active_count,
            "active_highwater": self._alloc.active_highwater,
            "page_size": self.page_size,
            "pages_total": self.num_pages,
            "pages_free": self._pool.free_count
            if self._pool is not None else 0,
            "pages_shared": self._pool.shared_count
            if self._pool is not None else 0,
            "page_faults": c["page_faults"],
            "pages_scrubbed": c["pages_scrubbed"],
        }
        s["quantized_kv"].update({"kv_quant": self.kv_quant,
                                  "paged_attention": self.paged_attention,
                                  "debug_parity": self.debug_parity})
        # one engine serves one mesh point: its compiles all land there
        s["mesh"] = self._mesh.stats() if self._mesh is not None else {
            "enabled": False, "devices": 1, "axes": {}, "model_axis": None,
            "slot_axis": None, "mesh_point": _MESH_POINT}
        if self._mesh is not None:
            # the port's plan exchange: plans rank 0 sent (their host
            # inputs' bytes) and the seconds in the exchange and status
            s["plans"] = dict(self._mesh.plans)
        s["compile"] = {"mesh_point": self._mesh_key,
                        "by_mesh_point": {self._mesh_key: c["compiles"]}
                        if c["compiles"] else {},
                        "compiles": c["compiles"],
                        "bucket_hits": c["bucket_hits"],
                        # each program compiles once
                        "programs": c["compiles"]}
        s["overload"]["controller"] = self._overload.snapshot()
        with self._lat_lock:
            ttft, lat = list(self._ttft), list(self._latency)
        s["latency"]["ttft"] = _percentiles(ttft)
        s["latency"]["request"] = _percentiles(lat)
        pref = c["prefix_hits"] + c["prefix_misses"]
        s["rates"] = {
            "prefix_hit_rate": round(c["prefix_hits"] / pref, 4)
            if pref else None,
            # accepted / proposed drafts (the bonus token each cycle
            # banks is not proposed, so a useless drafter reads 0.0)
            "spec_acceptance_rate": round(
                c["spec_tokens_accepted"] / c["spec_tokens_proposed"], 4)
            if c["spec_tokens_proposed"] else None}
        c["shed"] = c["rejected_queue_full"]
        c["rejected"] = c["rejected_invalid"]
        s["counters"] = c
        return s

    # ------------------------------------------------------------- programs
    def _call(self, key, fn, *args, count: bool = True):
        """Run program ``key`` (``fn`` over static buffers shaped by
        ``args``): its first call compiles it (a capture on the card),
        every later one is a bucket hit; ``count=False`` (a retry of the
        same step) counts neither.  Caches and the page table are
        allocated before the first program runs.  The watchdog's hang
        check is suspended while a program compiles."""
        self._ensure_caches()
        m = self._mesh
        if m is not None:
            if self._leads():
                # a device input is the last program's output (the
                # verify's drafts), which every rank computed alike
                m.send("call", key, tuple(
                    _PREV if isinstance(a, torch.Tensor) else a
                    for a in args), count)
                if m.status(0):
                    m.broken = True
                    raise EngineCrashedError(
                        "a follower rank of the mesh failed to apply a "
                        "plan", engine=self.name)
            m.refresh()
        prog = self._programs.get(key)
        first = prog is None
        if first:
            self.metrics.count("compiles")
            graph = self._graphs and self.device.type == "cuda" and \
                not (m is not None and m.staged)
            if graph and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._graph_stream = torch.cuda.Stream(self.device)
            prog = Program(key, fn, args, self.device, graph=graph,
                           pool=self._graph_pool, stream=self._graph_stream)
            self._programs[key] = prog
            self._compiling = True
        elif count:
            self.metrics.count("bucket_hits")
        try:
            with self.metrics.span(key[0]), self._mesh_scope():
                return prog(*args)
        except BaseException:
            if m is not None and m.followers:
                # the ranks may have parted inside the program
                m.broken = True
            raise
        finally:
            if first:
                self._compiling = False
                self._heartbeat = time.monotonic()

    # ----------------------------------------------------------------- mesh
    @property
    def _follower(self) -> bool:
        return self._mesh is not None and not self._mesh.leader

    def _leads(self) -> bool:
        """Whether this call sends a plan: rank 0 of a mesh with
        followers, outside ``warmup()`` (which every rank runs in step)."""
        m = self._mesh
        return m is not None and m.leader and m.followers and \
            not self._lockstep

    @contextlib.contextmanager
    def _in_step(self):
        prev, self._lockstep = self._lockstep, True
        try:
            yield
        finally:
            self._lockstep = prev

    def _mesh_scope(self):
        return use_mesh(self.mesh) if self.mesh is not None else \
            contextlib.nullcontext()

    def _effect(self, op, *args):
        """Cache surgery ``op``: applied here at once, and sent to the
        followers with the next plan."""
        self._apply(op, *args)
        if self._leads():
            self._mesh.effects.append(
                (op,) + tuple(a.copy() if isinstance(a, np.ndarray) else a
                              for a in args))

    def _apply(self, op, *args):
        """In-place surgery on this rank's caches (the programs hold
        their addresses): the page table's upload, scrubbed pages, every
        cache zeroed, one dense row zeroed, a K scale poisoned."""
        self._ensure_caches()
        if op == "table":
            self._table_dev.copy_(torch.from_numpy(args[0]))
            return
        if op == "kscale":
            self._caches[0]["k_scale"][args[0]] = args[1]
            return
        row = None
        if op == "zero_row":
            row = self._mesh.local_row(args[0]) if self._mesh is not None \
                else args[0]
            if row is None:
                return
        idx = self._dev(np.asarray(args[0], np.int64)) \
            if op == "scrub" else None
        for caches in (self._caches, self._parity_caches):
            for cache in caches or ():
                for a in cache.values():
                    if op == "scrub":
                        a.index_fill_(0, idx, 0)
                    elif op == "zero_row":
                        a[row].zero_()
                    else:
                        a.zero_()

    def _follow(self):
        """A follower's loop: receive rank 0's plans, apply their surgery,
        take part in the status word, run their programs, until ``stop``.
        Surgery that fails on a beat is reported at the next call's
        status word, before any program reads the caches.  A rank that
        fails raises out of ``start()``."""
        m = self._mesh
        self._heartbeat = time.monotonic()
        last = None
        code = 0
        try:
            while True:
                op, payload, effects = m.receive()
                try:
                    with self._step_lock:
                        for e in effects:
                            self._apply(*e)
                except Exception:
                    _log.exception("mesh follower: applying a plan failed")
                    code = 1
                if op == "stop":
                    return
                if op != "call":
                    continue
                if m.status(code):
                    raise EngineCrashedError(
                        "a rank of the mesh failed to apply a plan",
                        engine=self.name)
                key, args, count = payload
                args = tuple(last if isinstance(a, str) and a == _PREV
                             else a for a in args)
                with self._step_lock:
                    last = self._call(key, getattr(self, PROGRAMS[key[0]]),
                                      *args, count=count)
                self._heartbeat = time.monotonic()
        finally:
            self._batcher.close()

    def _release_followers(self):
        """Rank 0: end the followers' loops (the scheduler's last act)."""
        m = self._mesh
        if m is None or not m.leader or not m.followers or m.broken:
            return
        try:
            m.send("stop")
        except Exception:
            _log.exception("mesh leader: the stop plan failed")

    def _run_step(self, site: Optional[str], key, fn, args, reqs=()):
        """One program call with the injection site ``site`` (None: no
        site, as in ``warmup()``) and a bounded retry of retryable
        faults.  ``reqs`` ride the call: each retry spends one unit of
        every rider's budget; once any is exhausted (or no rider carries
        a budget) the fault escalates.  Injection fires before dispatch,
        so a retry never re-executes a partly applied step, and it
        replays the same program without counting a bucket hit again."""
        if site is None:
            return self._call(key, fn, *args)
        delay = self.retry_backoff
        counted = False
        while True:
            try:
                _inject(site, scope=self.name)
                # dispatch holds the step lock for a whole device step
                _note_blocking("serving.dispatch")
                if counted:
                    return self._call(key, fn, *args, count=False)
                counted = True
                return self._call(key, fn, *args)
            except RetryableFault:
                if not reqs or any(r.retries_left <= 0 for r in reqs):
                    raise
                for r in reqs:
                    r.retries_left -= 1
                self.metrics.count("retries")
                self.metrics.mark("retry")
                time.sleep(delay)
                delay *= 2

    def _ensure_caches(self):
        """The persistent device state every program captures: the KV
        caches (and the ``debug_parity`` twin) and the page table.
        Allocated once and never rebound: every later write to them —
        the NaN scrub, a dense row's zeroing, a scale poison, a failure's
        reset — is in place, so the next replay reads it."""
        if self._caches is not None:
            return
        if self._paged:
            # this rank's heads under a mesh (the shadow's blocks)
            self._caches = self._model.init_page_cache(
                self.num_pages + 1, self.page_size,
                kv_quant=self.kv_quant)
            if self.debug_parity:
                # the float32 twin: same page geometry, never quantized
                self._parity_caches = self._model.init_page_cache(
                    self.num_pages + 1, self.page_size)
            self._table_dev = torch.from_numpy(
                self._page_table.copy()).to(self.device)
            self._table_stale = False
        else:
            # slots + scratch + prefix pool rows; under a slot axis this
            # rank's block of them and a trash row
            slot = self._mesh.slot_rows if self._mesh is not None else None
            self._caches = self._model.init_slot_cache(
                self.num_slots + 1 + self.prefix_pool_rows if slot is None
                else slot[1] + 1, self.max_length)

    def _sync_table(self):
        """Upload the page table into its static device buffer if it
        changed: once a cycle, after every claim and before the first
        launch.  Changes made later in the cycle (a release at the first
        or last token, a speculation rewind, a failed request's release)
        only drop pages from rows that no later launch of the cycle
        writes through: a released row is parked at ``Tmax`` and a
        rewound one writes at positions its kept pages cover, and no
        page is claimed again before the next cycle's upload."""
        self._ensure_caches()
        if self._paged and self._table_stale:
            # a snapshot: the host table changes during the cycle, the
            # device copy stays as uploaded (as the card's does)
            self._effect("table", self._page_table)
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
    # A sampling program returns its tokens and the rows' finite flags
    # stacked in one int32 tensor (one host copy), and with debug_parity
    # its raw logits too.
    def _sampled(self, tokens, logits):
        ok = _row_ok(logits) if self.guard_nonfinite else \
            torch.ones_like(tokens)
        out = torch.stack([tokens, ok])
        return (out, logits) if self._dbg else out

    # Under a slot axis (:mod:`.sharded`) the per-row inputs of decode,
    # draft and verify are cut to this rank's rows and their outputs
    # joined again; a prefill writes the rows this rank holds, and a
    # chunk's logits come from the rank holding each row.  Without one
    # the helpers pass everything through.
    def _rows(self, a, fill):
        return a if self._mesh is None else self._mesh.rows_local(a, fill)

    def _joined(self, t, n):
        return t if self._mesh is None else self._mesh.rows_global(t, n)

    def _slot_idx(self, sidx):
        return sidx if self._mesh is None else self._mesh.slots_local(sidx)

    def _prog_decode(self, tok, pos, temp, topk, topp, seeds):
        logits, _ = self._model.decode_step(
            self._rows(tok, 0), self._caches,
            self._rows(pos, self.max_length), **self._paged_kw())
        logits = self._joined(logits, tok.shape[0])
        return self._sampled(
            sample_tokens(logits, temp, topk, topp, seeds, pos), logits)

    def _prog_prefill(self, toks, lens, sidx, temp, topk, topp, seeds):
        logits, _ = self._model.prefill_slots(
            toks, lens, self._caches, self._slot_idx(sidx),
            **self._paged_kw())
        return self._sampled(
            sample_tokens(logits, temp, topk, topp, seeds, lens - 1), logits)

    def _prog_chunk(self, toks, lens, sidx, off, temp, topk, topp, seeds):
        logits, _ = self._model.prefill_slots(
            toks, lens, self._caches, self._slot_idx(sidx), offset=off,
            **self._paged_kw())
        if self._mesh is not None:
            logits = self._mesh.pick_owner(logits, sidx)
        return self._sampled(
            sample_tokens(logits, temp, topk, topp, seeds, off + lens - 1),
            logits)

    def _prog_draft(self, tok, pos, temp, topk, topp, seeds, pois):
        out = self._model.draft_slots(
            self._rows(tok, 0), self._caches, self._rows(pos, self.max_length),
            self.spec_tokens, self.draft_layers, self._rows(temp, 0),
            self._rows(topk, 0), self._rows(topp, 1), self._rows(seeds, 0),
            poison=pois, page_table=self._table_dev if self._paged else None)
        return self._joined(out, tok.shape[0])

    def _prog_verify(self, tok, draft, pos, temp, topk, topp, seeds):
        """The (S, k + 1) window [tok, drafts]: its K/V are written and
        every column is sampled at its own position ``pos + i``, the
        (request seed, position) plain decode would use there.  Returns
        one (S, 2k + 2) int32 tensor: the verify tokens, the drafts
        (this program's own input, copied out) and each row's finite
        flag over the whole window."""
        window = torch.cat([tok[:, None], draft], dim=1)
        logits, _ = self._model.verify_slots(
            self._rows(window, 0), self._caches,
            self._rows(pos, self.max_length), **self._paged_kw())
        logits = self._joined(logits, tok.shape[0])
        s, w, v = logits.shape

        def rep(a):
            return a[:, None].expand(s, w).reshape(s * w)
        fpos = (pos[:, None].to(torch.int64)
                + torch.arange(w, device=pos.device)).reshape(s * w)
        vt = sample_tokens(logits.reshape(s * w, v), rep(temp), rep(topk),
                           rep(topp), rep(seeds), fpos)
        ok = _row_ok(logits) if self.guard_nonfinite else \
            torch.ones((s,), dtype=torch.int32, device=logits.device)
        return torch.cat([vt.reshape(s, w), draft.to(torch.int32),
                          ok[:, None]], dim=1)

    def _prog_copy(self, src, dst, length):
        m = self._mesh
        if m is not None and m.slot_rows is not None:
            m.copy_rows(self._caches, src, dst, length)
        else:
            copy_cache_rows(self._caches, src, dst, length)

    def _prog_forward(self, xs):
        """The block's output (one tensor, or a tuple of them) and each
        row's finite flag over every floating output."""
        with training_mode(False):
            out = self.net(xs)
        outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        ok = torch.ones((xs.shape[0],), dtype=torch.int32, device=xs.device)
        if self.guard_nonfinite:
            for o in outs:
                if o.is_floating_point():
                    ok = ok * _row_ok(o.reshape(o.shape[0], -1))
        return (out if isinstance(out, torch.Tensor) else outs), ok

    # debug_parity's float32 twins: the gather arm over the twin caches
    # and the live page table; each returns its logits
    def _prog_parity_decode(self, tok, pos):
        logits, _ = self.net.decode_step(tok, self._parity_caches, pos,
                                         page_table=self._table_dev)
        return logits

    def _prog_parity_prefill(self, toks, lens, sidx):
        logits, _ = self.net.prefill_slots(toks, lens, self._parity_caches,
                                           sidx, page_table=self._table_dev)
        return logits

    def _prog_parity_chunk(self, toks, lens, sidx, off):
        logits, _ = self.net.prefill_slots(toks, lens, self._parity_caches,
                                           sidx, offset=off,
                                           page_table=self._table_dev)
        return logits

    def _prog_parity_copy(self, src, dst, length):
        copy_cache_rows(self._parity_caches, src, dst, length)

    # The engine's device calls, each one program call.  ``site`` is the
    # fault site (None in warmup() and direct calls), ``riders`` the
    # requests whose retry budgets a retryable fault spends.
    def _primary(self, out):
        if self._dbg:
            out, self._dbg_logits = out
        return _host(out)

    def _run_prefill(self, toks, lens, sidx, samp, off=None, site=None,
                     riders=()):
        """One full (``off=None``) or chunked prefill call: (2, bb) on
        the host, the token sampled at each row's last real position and
        the row's finite flag."""
        bb, tb = toks.shape
        if off is None:
            out = self._run_step(site, ("prefill", bb, tb),
                                 self._prog_prefill,
                                 (toks, lens, sidx) + tuple(samp), riders)
        else:
            out = self._run_step(site, ("chunk", bb, tb), self._prog_chunk,
                                 (toks, lens, sidx, off) + tuple(samp),
                                 riders)
        return self._primary(out)

    def _run_decode(self, tok, pos, samp, site=None, riders=()):
        """One decode step: (2, S + 1) on the host, tokens and flags."""
        return self._primary(self._run_step(
            site, ("decode",), self._prog_decode, (tok, pos) + tuple(samp),
            riders))

    def _run_draft(self, tok, pos, samp, pois=None, site=None):
        """The drafts (S + 1, k), on the device (the verify's input).
        ``pois`` is the ``serving.draft_logits`` value (0.0 without a
        plan)."""
        pois = np.asarray(0.0 if pois is None else pois, np.float32)
        return self._run_step(site, ("draft",), self._prog_draft,
                              (tok, pos) + tuple(samp) + (pois,))

    def _run_verify(self, tok, draft, pos, samp, site=None):
        """The verify window: (drafts (S + 1, k), verify tokens
        (S + 1, k + 1), flags (S + 1,)) on the host."""
        k = self.spec_tokens
        out = _host(self._run_step(site, ("verify",), self._prog_verify,
                                   (tok, draft, pos) + tuple(samp)))
        return out[:, k + 1:2 * k + 1], out[:, :k + 1], out[:, -1]

    def _run_spec(self, tok, pos, samp):
        """Draft k tokens per row (read-only on the caches), then verify
        the window: (drafts, verify tokens, flags) on the host."""
        return self._run_verify(tok, self._run_draft(tok, pos, samp), pos,
                                samp)

    def _copy_rows(self, src, dst, length, site=None):
        """Positions ``[0, length)`` of cache row (or page) ``src`` into
        ``dst``: the prefix copy program, mirrored into the
        ``debug_parity`` twin."""
        args = tuple(np.asarray(v, np.int64) for v in (src, dst, length))
        self._run_step(site, ("prefix_copy",), self._prog_copy, args)
        if self._parity_caches is not None:
            try:
                self._call(("parity_copy",), self._prog_parity_copy, *args)
            except Exception:
                self._parity_off()

    def _forward_program(self, xs, shape_key):
        """The forward program's output for the batch ``xs`` (on the
        device): warmup() and direct calls."""
        return self._call(("forward", xs.shape[0]) + shape_key,
                          self._prog_forward, xs)[0]

    _PARITY = {"decode": ("parity_decode", "_prog_parity_decode"),
               "prefill": ("parity_prefill", "_prog_parity_prefill"),
               "chunk": ("parity_chunk", "_prog_parity_chunk")}

    def _parity(self, kind, args, rows):
        """debug_parity: run the twin of program ``kind`` over the same
        tokens and page table, and feed the max-abs logit delta of the
        live ``rows`` (against the primary's logits of its call just
        before) into the ``kv_quant_error`` histogram.  Any twin failure
        disables the twin for good and never fails a request."""
        if self._parity_caches is None:
            return
        name, fn = self._PARITY[kind]
        key = (name,) if kind == "decode" else \
            (name,) + tuple(args[0].shape)
        try:
            ref = self._call(key, getattr(self, fn), *args)
            if rows:
                idx = torch.as_tensor(rows, device=ref.device)
                d = (self._dbg_logits.float()[idx] - ref.float()[idx]).abs()
                self.metrics.observe_quant_error(float(d.max()))
        except Exception:
            self._parity_off()

    def _parity_off(self):
        self._parity_caches = None
        self.debug_parity = False

    # ------------------------------------------------------------- scheduler
    def _loop(self):
        try:
            self._schedule()
        finally:
            # the scheduler's last act ends the mesh followers' loops
            self._release_followers()

    def _schedule(self):
        cycle = self._forward_cycle if self.mode == "forward" \
            else self._cycle
        m = self._mesh
        while True:
            self._heartbeat = time.monotonic()
            # outside the recovery net: a raise here kills the scheduler,
            # which is the crash the watchdog exists to detect
            _inject("serving.scheduler", scope=self.name)
            with self._cond:
                idle = self._batcher.empty() and \
                    self._alloc.active_count == 0
                if idle:
                    if self._stopping:
                        return
                    # the controller keeps ticking while idle, or a
                    # brownout could never lift once the storm passed
                    self._overload_tick(time.monotonic())
                    self._cond.wait(0.05)
            if idle:
                if self._leads() and not m.broken and \
                        time.monotonic() - m.last_plan > BEAT:
                    m.send("beat")
                continue
            try:
                with self._step_lock:
                    self._cycle_busy = True
                    try:
                        cycle()
                    finally:
                        self._cycle_busy = False
            except Exception as e:  # boundary: never leave futures hung
                _log.exception("serving cycle failed; failing in-flight "
                               "requests")
                with self._step_lock:
                    if m is not None and m.broken:
                        # the ranks parted: no plan reaches the followers,
                        # so the engine is condemned before any rider's
                        # future resolves
                        self._watchdog_trip(
                            f"mesh rank failed: {type(e).__name__}: {e}")
                        self._fail_inflight(e)
                        return
                    self._fail_inflight(e)
            # a BaseException (a simulated kill) escapes on purpose: the
            # dead thread is what the watchdog detects

    def _cycle(self):
        """Sweep cancels and deadlines, tick the controller, preempt for
        waiting interactive work; admit; claim every page the cycle
        writes (prefill chunks, the first decode page of a prompt
        finishing now, decode growth and the speculation window); upload
        the table once; prefill; then one decode step or one speculative
        cycle."""
        now = time.monotonic()
        self._sweep_cancelled()
        for slot, st in self._alloc.items():
            if st.request.expired(now):
                self._release(slot)
                self._fail(st.request, RequestTimeoutError(
                    f"request {st.request.id} timed out after "
                    f"{len(st.generated)} tokens"))
        self._overload_tick(now)
        # before admission: the slots it frees are leased this cycle
        self._preempt_cycle(now)
        free = self._alloc.free_count
        if free and not self._batcher.empty():
            # only an idle engine waits for a batch to fill: with
            # requests in flight, arrivals ride the next cycle
            wait_us = self.MAX_WAIT_US if self._alloc.active_count == 0 \
                else 0
            reqs = self._batcher.get_batch(
                min(free, self.lattice.max_batch), wait_us, wait=False)
            self._admit(self._filter_expired(reqs))
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
        if self.kv_quant:
            # the serving.kv_scale poison: caught at dequant by the guard
            # of the next step that reads the page
            bad = _poison("serving.kv_scale")
            if bad is not None:
                self._poison_scale(float(bad))
        if any(not st.prefilling and not st.waiting
               for _s, st in self._alloc.items()):
            if self.spec_tokens and self._spec_pages_ok:
                self._spec_step()
            else:
                self._decode_step()

    def _forward_cycle(self):
        """One forward batch: live requests of one (shape, dtype),
        padded to a batch bucket, one program call, rows scattered
        back; a row whose output is not finite fails typed."""
        self._overload_tick(time.monotonic())
        reqs = self._batcher.get_batch(self.max_batch, self.MAX_WAIT_US,
                                       compatible=lambda r: r.shape_key,
                                       wait=False)
        if not reqs:
            return
        live = self._filter_expired(reqs)
        if not live:
            return
        now = time.monotonic()
        for r in live:
            r.t_schedule = now
        bb = self.lattice.batch(len(live))
        xs = np.stack([r.payload for r in live] +
                      [np.zeros_like(live[0].payload)] * (bb - len(live)))
        self.metrics.count("admitted", len(live))
        self.metrics.count("forward_batches")
        self.metrics.mark("admit", len(live))
        key = ("forward", bb) + live[0].shape_key
        # the popped batch lives in neither the batcher nor the slot
        # allocator: a watchdog trip during a hung call still fails it
        self._inflight_fwd = tuple(live)
        tr = _trace_active()
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            out, ok = self._run_step("serving.forward", key,
                                     self._prog_forward, (xs,), live)
            single = isinstance(out, torch.Tensor)
            outs = [_host(o) for o in ((out,) if single else out)]
            ok = _host(ok)
            if tr is not None:
                tr.record_span(
                    "serving.forward", t0, time.monotonic(),
                    trace_ids=tuple(r.trace_id for r in live
                                    if r.trace_id is not None), batch=bb)
        except BaseException as e:
            # the popped batch fails here, the queue is untouched
            for r in live:
                self._fail(r, e)
            return
        finally:
            self._inflight_fwd = ()
        done = time.monotonic()
        for i, r in enumerate(live):
            if not ok[i]:
                self.metrics.count("nonfinite_outputs")
                self._fail(r, NonFiniteOutputError(
                    f"request {r.id}: non-finite forward output — the "
                    "model produced NaN/Inf for this input"))
                continue
            res = outs[0][i] if single else tuple(o[i] for o in outs)
            self.metrics.observe_request(r.t_schedule - r.t_submit,
                                         done - r.t_schedule)
            self.metrics.count("completed")
            self.metrics.count_served(r.priority_name)
            with self._lat_lock:
                self._latency.append(done - r.t_submit)
            if tr is not None and r.trace_id is not None:
                tr.record_span("serving.queue", r.t_submit, r.t_schedule,
                               trace_id=r.trace_id)
                tr.record_span("serving.request", r.t_submit, done,
                               trace_id=r.trace_id, request=r.id)
                tr.event("serving.complete", trace_id=r.trace_id)
            r.future.set_result(res)

    def _filter_expired(self, reqs):
        """Fail deadline-blown queued requests; return the live rest."""
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.expired(now):
                self._fail(r, RequestTimeoutError(
                    f"request {r.id} timed out in queue"))
            else:
                live.append(r)
        return live

    def _fail(self, req: Request, exc: BaseException):
        req.future.set_exception(exc)
        if isinstance(exc, RequestTimeoutError):
            self.metrics.count("timeouts")
            self.metrics.mark("timeout")
        elif isinstance(exc, (EngineStoppedError, RequestCancelledError)):
            self.metrics.count("cancelled")
        tr = _trace_active()
        if tr is not None and req.trace_id is not None:
            tr.event("serving.error", trace_id=req.trace_id,
                     error=type(exc).__name__)
        fr = _fr_active()
        if fr is not None:
            fr.record("serving.error", engine=self.name, request=req.id,
                      error=type(exc).__name__, trace_id=req.trace_id)

    def _fail_inflight(self, exc: BaseException):
        """Fail every queued and in-flight request.  If any was in
        flight, zero the device caches in place too (a failed step may
        have left them half-written: the programs hold their
        addresses), and drop every prefix entry and page claim."""
        for req in self._batcher.drain():
            self._fail(req, exc)
        inflight = self._alloc.items()
        for slot, st in inflight:
            self._release(slot)
            self._fail(st.request, exc)
        if inflight:
            if self._caches is not None:
                self._effect("zero")
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
            if self._prefix is not None:
                self._prefix.unpin(st.pinned)
            st.pinned = None
        freed = []
        if self._paged:
            freed = self._pool.release(st.pages)
            st.pages = []
            st.pages_shared = 0
            st.waiting = False
            self._page_table[slot, :] = self._pool.scratch
            self._table_stale = True
        return freed

    def _overload_tick(self, now: float):
        """One AIMD tick: queue depth against capacity plus deadline
        misses since the last one.  Host-only."""
        t = self.metrics.counters["timeouts"]
        entered = self._overload.update(len(self._batcher),
                                        t - self._timeouts_seen, now)
        self._timeouts_seen = t
        if entered:
            self.metrics.count("brownouts")
            self.metrics.mark("brownout")
            fr = _fr_active()
            if fr is not None:
                fr.record("serving.brownout", engine=self.name,
                          reason="overload")

    def _sweep_cancelled(self):
        """Free the slots of requests cancelled mid-decode; a cancelled
        request preempted since is dequeued; anything unmatched carries
        over to the next sweep."""
        if not self._cancels:
            return
        with self._cond:
            cancels, self._cancels = self._cancels, set()
        for slot, st in list(self._alloc.items()):
            if st.request.future in cancels:
                cancels.discard(st.request.future)
                self._release(slot)
                self._fail(st.request, RequestCancelledError(
                    f"request {st.request.id} cancelled mid-decode "
                    f"after {len(st.generated)} tokens"))
        carry = set()
        for fut in cancels:
            if fut.done():
                continue
            req = self._batcher.remove(fut)
            if req is not None:
                self._fail(req, RequestCancelledError(
                    f"request {req.id} cancelled while requeued"))
            else:
                carry.add(fut)
        if carry:
            with self._cond:
                self._cancels |= carry

    def _poison_scale(self, value: float):
        """Apply a ``serving.kv_scale`` poison: ``value`` into the
        layer-0 K scale of the last page of the first slot holding
        pages, in place (the programs read that buffer)."""
        if self._caches is None:
            return
        pid = None
        for _slot, st in self._alloc.items():
            if st.pages:
                pid = st.pages[-1]
                break
        if pid is None or "k_scale" not in self._caches[0]:
            return
        self._effect("kscale", pid, value)

    # ------------------------------------------------------------ admission
    def _admit(self, reqs):
        """Lease a slot per request; a prefix hit fills its matched
        positions now, so prefill only sees the suffix.  Paged: admit
        while a running budget of available pages covers the prompt and
        the first decode page; a blocked request and everything behind
        it go back to the front of their classes, in order."""
        now = time.monotonic()
        tr = _trace_active()
        n_prompt = admitted = 0
        budget = self._pages_available() if self._paged else 0
        for i, req in enumerate(reqs):
            need = self._page_need(req) if self._paged else 0
            if self._paged and not self._page_admissible(need, budget):
                for r in reversed(reqs[i:]):
                    try:
                        self._batcher.requeue(r)
                    except EngineStoppedError as e:
                        self._fail(r, e)
                break
            budget -= need
            st = SlotState(req, req.prompt_len, req.max_new_tokens,
                           tokens=req.payload)
            st.t_schedule = req.t_schedule = now
            slot = self._alloc.alloc(st)
            admitted += 1
            if req.preempted:
                self.metrics.count("preempt_resumes")
            if tr is not None and req.trace_id is not None:
                tr.record_span("serving.queue", req.t_submit, now,
                               trace_id=req.trace_id, slot=slot)
            n_prompt += req.prompt_len
            if self._prefix_usable() and req.prompt_len > 1:
                self._prefix_admit(st, slot)
        if admitted:
            self.metrics.count("admitted", admitted)
            self.metrics.count("prompt_tokens", n_prompt)
            self.metrics.mark("admit", admitted)

    def _pages_available(self) -> int:
        """Free pages plus what evicting every idle prefix entry would
        free: a cached prefix never blocks live work."""
        avail = self._pool.free_count
        if self._prefix_usable():
            avail += self._prefix.evictable_pages()
        return avail

    def _page_need(self, req: Request) -> int:
        """The prompt plus the first decode page (a hit claims fewer)."""
        return self._pool.pages_for(min(req.prompt_len + 1,
                                        self.max_length))

    def _page_admissible(self, need, budget) -> bool:
        """Admit while the batch's page budget covers the request; a
        blocked request waits queued.  A fault at ``serving.page_alloc``
        blocks the same way."""
        try:
            _inject("serving.page_alloc", scope=self.name)
        except Exception:
            self.metrics.count("page_faults")
            return False
        if budget >= need:
            return True
        self.metrics.count("page_faults")
        return False

    # --------------------------------------------------------- prefix cache
    def _prefix_usable(self) -> bool:
        return self._prefix is not None and not self._prefix_disabled

    def _prefix_fault(self, where: str):
        """A fault at a ``serving.prefix_*`` site: the request loses the
        shortcut, never fails; ``prefix_fault_limit`` consecutive faults
        at one site disable the cache."""
        self.metrics.count("prefix_faults")
        self.metrics.mark("prefix_fault")
        self._prefix_faults[where] += 1
        if self._prefix_faults[where] >= self.prefix_fault_limit and \
                not self._prefix_disabled:
            self._prefix_disabled = True
            self.metrics.mark("prefix_disabled")

    def _prefix_admit(self, st: SlotState, slot: int):
        """Longest-prefix lookup, then the dense row copy or the paged
        page sharing.  At least one prompt token is left to prefill: its
        logits give the first token.  A contained fault prefills in
        full."""
        req = st.request
        tr = _trace_active()
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            _inject("serving.prefix_lookup")
            hit = self._prefix.lookup(req.payload)
        except Exception:
            self._prefix_fault("lookup")
            return
        if tr is not None and req.trace_id is not None:
            tr.record_span("serving.prefix_lookup", t0, time.monotonic(),
                           trace_id=req.trace_id, hit=hit is not None)
        self._prefix_faults["lookup"] = 0
        if hit is None:
            self.metrics.count("prefix_misses")
            return
        match, entry = hit
        match = min(match, st.prompt_len - 1)
        if match < self.prefix_min_tokens:
            self.metrics.count("prefix_misses")
            return
        if self._paged:
            self._prefix_admit_paged(st, slot, entry, match)
            return
        self._prefix.pin(entry)
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            # no riders: an optional copy never spends a retry budget
            self._copy_rows(entry.row, slot, match,
                            site="serving.prefix_copy")
        except Exception:
            self._prefix.unpin(entry)
            self._prefix_fault("copy")
            return
        if tr is not None and req.trace_id is not None:
            tr.record_span("serving.prefix_copy", t0, time.monotonic(),
                           trace_id=req.trace_id, tokens=match)
        self._prefix_faults["copy"] = 0
        st.filled = match
        st.pinned = entry             # read-pinned until prefill completes
        self.metrics.count("prefix_hits")
        self.metrics.count("prefix_tokens_saved", match)

    def _prefix_admit_paged(self, st, slot, entry, match):
        """Share every whole matched page by refcount (read-only to this
        slot: its suffix starts past them) and copy a partial tail page
        into a fresh page of its own, int8 scales included; a fault at
        ``serving.page_copy`` degrades to the whole pages."""
        ps = self.page_size
        match = min(match, entry.length)
        n_full = match // ps
        for i in range(n_full):
            pid = entry.pages[i]
            self._pool.ref(pid)
            st.pages.append(pid)
            self._page_table[slot, i] = pid
        self._table_stale = True
        st.pages_shared = n_full
        filled = n_full * ps
        rem = match - filled
        if rem:
            self._prefix.pin(entry)   # the tail's source must survive
            newp = self._claim_pages(1)
            if newp is not None:
                try:
                    self._copy_rows(entry.pages[n_full], newp[0], rem,
                                    site="serving.page_copy")
                except Exception:
                    self._pool.unref(newp[0])
                    self._prefix.unpin(entry)
                    self._prefix_fault("copy")
                else:
                    self._prefix_faults["copy"] = 0
                    st.pages.append(newp[0])
                    self._page_table[slot, n_full] = newp[0]
                    filled += rem
                    st.pinned = entry
            else:
                self.metrics.count("page_faults")
                self._prefix.unpin(entry)
        if filled < self.prefix_min_tokens:
            # nothing usable shared: a plain miss
            self._pool.release(st.pages)
            st.pages = []
            st.pages_shared = 0
            self._page_table[slot, :] = self._pool.scratch
            self.metrics.count("prefix_misses")
            return
        st.filled = filled
        self.metrics.count("prefix_hits")
        self.metrics.count("prefix_tokens_saved", filled)

    def _prefix_insert(self, st: SlotState, slot: int):
        """A prefill just completed: cache the whole prompt, unless a
        brownout pauses new inserts (preemption parking bypasses the
        pause)."""
        if not self._prefix_usable() or \
                st.prompt_len < self.prefix_min_tokens:
            return
        if self._overload.pause_inserts:
            self.metrics.count("prefix_inserts_paused")
            return
        self._pool_insert(st.tokens, slot, st.prompt_len, st)

    def _pool_insert(self, tokens, slot, length, st):
        """Dense: reserve a pool row (evicting the least recently used
        idle entry if none is free) and copy the slot's K/V ``[0,
        length)`` into it.  Paged: the entry takes refcounts on the
        slot's pages covering ``[0, length)``; a partial last page is
        shared too, since the donor writes only positions past
        ``length`` in it, which no reader reads."""
        try:
            _inject("serving.prefix_lookup")
            if self._paged:
                npages = self._pool.pages_for(length)
                if npages > len(st.pages):
                    return
                entry = self._prefix.insert(tokens, st.pages[:npages],
                                            length)
            else:
                ev0 = self._prefix.evictions
                entry = self._prefix.insert(tokens)
                self.metrics.count("prefix_evictions",
                                   self._prefix.evictions - ev0)
        except Exception:
            self._prefix_fault("lookup")
            return
        self._prefix_faults["lookup"] = 0
        if entry is None:
            return
        if self._paged:
            self.metrics.count("prefix_inserts")
            return
        try:
            self._copy_rows(slot, entry.row, length,
                            site="serving.prefix_copy")
        except Exception:
            self._prefix.remove(entry)
            self._prefix_fault("copy")
            return
        self._prefix_faults["copy"] = 0
        self.metrics.count("prefix_inserts")

    # ---------------------------------------------------------- paged pages
    def _evict_hook(self):
        """The pool's reclaim hook: evict idle prefix entries, least
        recently used first, until ``k`` pages freed."""
        if not self._prefix_usable():
            return None
        cache, metrics = self._prefix, self.metrics

        def reclaim(k):
            ev0 = cache.evictions
            freed = cache.evict_pages(k)
            metrics.count("prefix_evictions", cache.evictions - ev0)
            return freed
        return reclaim

    def _claim_pages(self, n: int, reclaim: bool = True):
        """Allocate ``n`` pages, evicting idle prefix entries if the free
        list is short (``reclaim=False``, the speculation window's soft
        claim, takes the free list only), and scrub any that a
        non-finite victim left dirty."""
        pages = self._pool.alloc(n, self._evict_hook() if reclaim else None)
        if pages and self.kv_quant:
            self.metrics.count("kv_quant_pages", len(pages))
        if pages and self._pool.dirty:
            tainted = [p for p in pages if p in self._pool.dirty]
            if tainted:
                self._scrub_pages(tainted)
                self._pool.dirty.difference_update(tainted)
        return pages

    def _ensure_pages(self, slot, st, upto) -> str:
        """Grow ``slot``'s pages to cover positions ``[0, upto)``:
        ``"ok"``; ``"retry"`` (an injected ``serving.page_alloc`` fault:
        the slot sits this cycle out); ``"full"`` (no victim left: the
        caller preempts the slot itself).  When the pool runs dry, idle
        prefix entries go first, then other slots by
        :meth:`_page_victim`."""
        need = self._pool.pages_for(upto) - len(st.pages)
        if need <= 0:
            st.waiting = False
            return "ok"
        try:
            _inject("serving.page_alloc", scope=self.name)
        except Exception:
            self.metrics.count("page_faults")
            st.waiting = True
            return "retry"
        pages = self._claim_pages(need)
        while pages is None:
            self.metrics.count("page_faults")
            self.metrics.mark("page_fault")
            fr = _fr_active()
            if fr is not None:
                fr.record("serving.page_fault", engine=self.name, slot=slot,
                          need=need, request=st.request.id)
            victim = self._page_victim(slot, st.request.priority)
            if victim is None:
                st.waiting = True
                return "full"
            self._preempt(*victim)
            pages = self._claim_pages(need)
        base = len(st.pages)
        st.pages.extend(pages)
        self._page_table[slot, base:base + need] = pages
        self._table_stale = True
        st.waiting = False
        return "ok"

    def _page_victim(self, exclude, floor):
        """The slot whose parking relieves page pressure at the least
        cost: lowest class first, youngest admission within it, never
        ``exclude`` (the grower: the oldest work keeps running, which
        guarantees progress, as every request fits the pool alone) and
        never a class above the grower's (``floor``)."""
        cands = [(slot, st) for slot, st in self._alloc.items()
                 if slot != exclude and st.pages
                 and st.request.priority >= floor]
        if not cands:
            return None
        # stable: among one admission batch the highest slot goes first
        cands.sort(key=lambda it: (it[1].request.priority,
                                   it[1].t_schedule))
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
            if self._ensure_pages(slot, st, st.pos + 1) == "full":
                self._preempt(slot, st)
                continue
            if not self.spec_tokens or st.waiting:
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

    def _scrub_pages(self, freed, count: bool = True):
        """Zero ``freed`` pages in every layer (int8 scales too) of the
        caches and the twin, in place, so a page crossing tenants
        carries nothing of the last one.  ``count=False`` (the
        speculative rewind) keeps ``pages_scrubbed`` the NaN signal."""
        if not freed or self._caches is None:
            return
        self._effect("scrub", np.asarray(freed, np.int64))
        if count:
            self.metrics.count("pages_scrubbed", len(freed))
            fr = _fr_active()
            if fr is not None:
                fr.record("serving.scrub", engine=self.name,
                          pages=len(freed))

    def _rewind_pages(self, slot, st, scrub=True):
        """Release pages claimed past the slot's next write position
        (``st.pos``): the speculation window's claims beyond the
        accepted tokens.  After a verify wrote them, freed pages are
        scrubbed; a degraded cycle's claims were never written (a page
        still dirty from an older victim keeps its mark)."""
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
                self._scrub_pages(freed, count=False)
                self._pool.dirty.difference_update(freed)
            self.metrics.count("spec_pages_rewound", len(freed))

    # ----------------------------------------------------------- preemption
    def _preempt_cycle(self, now: float):
        """An ``interactive`` request waiting with every slot busy may
        preempt a ``best_effort`` decode whose progress can park (or is
        shorter than ``prefix_min_tokens``): the victims with the most
        budget left go first, one per waiting request."""
        if not self.preemption or self._alloc.free_count:
            return
        waiting = self._batcher.waiting_at_or_above(PRIORITY_INTERACTIVE,
                                                    now)
        if not waiting:
            return
        parkable = self._prefix_usable()
        victims = [(slot, st) for slot, st in self._alloc.items()
                   if not st.prefilling
                   and st.request.priority == PRIORITY_BEST_EFFORT
                   and (parkable or st.pos < self.prefix_min_tokens)]
        if not victims:
            return
        victims.sort(key=lambda it: len(it[1].generated)
                     - it[1].max_new_tokens)
        for slot, st in victims[:waiting]:
            try:
                _inject("overload.preempt")
            except Exception:
                # a faulted attempt aborts: the victim keeps decoding
                self.metrics.count("overload_faults")
                continue
            self._preempt(slot, st)

    def _preempt(self, slot: int, st: SlotState):
        """Park a slot by reference: its progress (a decoding slot's K/V
        ``[0, pos)``, a prefilling one's ``[0, filled)``) becomes an
        evictable prefix entry, and its continuation — the prompt plus
        the tokens so far, the same future, deadline, trace id and retry
        budget — requeues at the front of its class and resumes by
        prefix hit."""
        req = st.request
        seq = np.concatenate([req.payload, np.asarray(st.generated,
                                                      np.int32)]) \
            if st.generated else req.payload
        park = st.filled if st.prefilling else st.pos
        if self._prefix_usable() and park >= self.prefix_min_tokens:
            self._pool_insert(seq[:park], slot, park, st)
        self._release(slot)
        cont = Request("decode", seq, st.max_new_tokens - len(st.generated),
                       req.eos_id, req.deadline, priority=req.priority,
                       temperature=req.temperature, top_k=req.top_k,
                       top_p=req.top_p, seed=req.seed)
        cont.future = req.future
        cont.t_submit = req.t_submit
        cont.t_first = req.t_first
        cont.trace_id = req.trace_id
        cont.retries_left = req.retries_left
        cont.preempted = req.preempted + 1
        try:
            self._batcher.requeue(cont)
        except EngineStoppedError as e:
            self._fail(cont, e)
            return
        self.metrics.count("preemptions")
        # the continuation's completion counts only its own tokens
        self.metrics.count("tokens_generated", len(st.generated))
        self.metrics.mark("preempt")
        tr = _trace_active()
        if tr is not None and req.trace_id is not None:
            tr.event("serving.preempt", trace_id=req.trace_id,
                     request=req.id, generated=len(st.generated))
        fr = _fr_active()
        if fr is not None:
            fr.record("serving.preempt", engine=self.name, request=req.id,
                      generated=len(st.generated),
                      priority=req.priority_name, trace_id=req.trace_id)

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
                got = self._ensure_pages(slot, st, st.filled + take)
                if got == "full":
                    self._preempt(slot, st)
                    continue
                if got == "retry":
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

    def _quant_write_ok(self) -> bool:
        """``serving.kv_quant``: a quantize-write fault makes the batch
        sit this cycle out (the fault fires before any launch, so no
        page holds a torn write) and the next cycle runs it again."""
        if not self.kv_quant:
            return True
        try:
            _inject("serving.kv_quant", scope=self.name)
        except Exception:
            self.metrics.count("kv_quant_faults")
            fr = _fr_active()
            if fr is not None:
                fr.record("serving.kv_quant", engine=self.name,
                          outcome="recompute")
            return False
        return True

    def _prefill_full(self, rows, tb):
        if not self._quant_write_ok():
            return
        bb = self.lattice.batch(len(rows))
        toks = np.zeros((bb, tb), np.int32)
        lens = np.ones((bb,), np.int32)
        sidx = np.full((bb,), self._alloc.scratch, np.int32)
        for i, (slot, st) in enumerate(rows):
            toks[i, :st.prompt_len] = st.tokens
            lens[i] = st.prompt_len
            sidx[i] = slot
        self.metrics.count("padded_tokens",
                           bb * tb - sum(st.prompt_len for _s, st in rows))
        self.metrics.count("prefill_batches")
        tr = _trace_active()
        t0 = time.monotonic() if tr is not None else 0.0
        out = self._run_prefill(
            toks, lens, sidx,
            self._samp_rows([st.request for _s, st in rows], bb),
            site="serving.prefill", riders=[st.request for _s, st in rows])
        self._parity("prefill", (toks, lens, sidx), list(range(len(rows))))
        if tr is not None:
            tr.record_span(
                "serving.prefill", t0, time.monotonic(),
                trace_ids=tuple(st.request.trace_id for _s, st in rows
                                if st.request.trace_id is not None),
                batch=bb, seq=tb)
        for i, (slot, st) in enumerate(rows):
            if not out[1, i]:
                self._fail_nonfinite(slot, st, "prefill")
                continue
            st.filled = st.prompt_len
            self._first_token(slot, st, int(out[0, i]))

    def _prefill_chunk_batch(self, rows):
        """One offset prefill over up to ``max_batch`` rows: row i writes
        its next ``min(remaining, prefill_chunk)`` prompt tokens behind
        its populated ``[0, filled)``."""
        if not self._quant_write_ok():
            return
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
        self.metrics.count("padded_tokens", bb * tb - sum(take))
        self.metrics.count("prefill_chunks")
        tr = _trace_active()
        t0 = time.monotonic() if tr is not None else 0.0
        out = self._run_prefill(
            toks, lens, sidx,
            self._samp_rows([st.request for _s, st in rows], bb), off=off,
            site="serving.prefill", riders=[st.request for _s, st in rows])
        self._parity("chunk", (toks, lens, sidx, off),
                     list(range(len(rows))))
        if tr is not None:
            tr.record_span(
                "serving.prefill_chunk", t0, time.monotonic(),
                trace_ids=tuple(st.request.trace_id for _s, st in rows
                                if st.request.trace_id is not None),
                batch=bb, seq=tb)
        for i, (slot, st) in enumerate(rows):
            if not out[1, i]:
                # any chunk's non-finite logits mean the K/V it just
                # wrote are poisoned: fail now, not at the last chunk
                self._fail_nonfinite(slot, st, "prefill")
                continue
            st.filled += take[i]
            if st.filled == st.prompt_len:
                self._first_token(slot, st, int(out[0, i]))

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

    def _fail_nonfinite(self, slot: int, st: SlotState, where: str):
        """One request's logits went NaN/Inf: free its slot and fail it
        typed; the rest of the batch, the scheduler and the watchdog are
        untouched.  Its pages (paged) or row (dense) hold NaN K/V, which
        a later tenant must never read: the pages it wrote that freed
        are scrubbed in place, those another reader still holds are
        marked dirty (scrubbed at their next claim), and a dense row is
        zeroed in place.  Under int8 the scale sidecar of its pages is
        scanned: a tainted scale can sit inside a shared prefix, so
        every prefix entry over a tainted page is dropped."""
        written = list(st.pages[st.pages_shared:]) if self._paged else ()
        tainted: set = set()
        if self.kv_quant and self._caches is not None and st.pages:
            pids = self._dev(np.asarray(st.pages, np.int64))
            for layer in self._caches:
                for key in ("k_scale", "v_scale"):
                    bad = ~torch.isfinite(layer[key][pids]).flatten(1).all(1)
                    tainted.update(int(p) for p, b in
                                   zip(st.pages, bad.tolist()) if b)
            if tainted:
                self.metrics.count("kv_dequant_faults")
                fr0 = _fr_active()
                if fr0 is not None:
                    fr0.record("serving.kv_scale", engine=self.name,
                               request=st.request.id, pages=sorted(tainted),
                               outcome="tainted")
        freed = self._release(slot)
        if self._paged:
            if tainted and self._prefix is not None:
                for entry in [e for e in self._prefix._entries
                              if e.pages and tainted.intersection(e.pages)]:
                    self._prefix.remove(entry)
            scrub = set(freed) | {p for p in tainted
                                  if self._pool.refs(p) == 0}
            self._scrub_pages(sorted(scrub))
            self._pool.mark_dirty((set(written) | tainted) - scrub)
        elif self._caches is not None:
            self._effect("zero_row", slot)
        self.metrics.count("nonfinite_outputs")
        fr = _fr_active()
        if fr is not None:
            fr.nonfinite(engine=self.name, request=st.request.id,
                         where=where, trace_id=st.request.trace_id)
        self._fail(st.request, NonFiniteOutputError(
            f"request {st.request.id}: non-finite logits in {where} after "
            f"{len(st.generated)} generated tokens — the model produced "
            "NaN/Inf for this input"))

    # --------------------------------------------------------------- decode
    def _decode_rows(self):
        """The fixed-shape (S+1,) tokens, positions and sampling rows of
        a decode step, and the riding (slot, state) pairs.  Rows not
        decoding (free slots, the scratch row, slots mid-prefill or
        waiting on pages) park at ``pos = Tmax``, so their writes land
        in the trash target."""
        s1 = self.num_slots + 1
        tok = np.zeros((s1,), np.int32)
        pos = np.full((s1,), self.max_length, np.int32)
        reqs = [None] * s1
        riders = []
        for slot, st in self._alloc.items():
            if st.prefilling or st.waiting:
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
        self.metrics.count("decode_steps")
        tr = _trace_active()
        t0 = time.monotonic() if tr is not None else 0.0
        reqs = [st.request for _s, st in riders]
        out = self._run_decode(tok, pos, samp, site="serving.decode_step",
                               riders=reqs)
        self._parity("decode", (tok, pos), [s for s, _st in riders])
        if tr is not None:
            tr.record_span(
                "serving.decode_step", t0, time.monotonic(),
                trace_ids=tuple(r.trace_id for r in reqs
                                if r.trace_id is not None),
                riders=len(reqs))
        for slot, st in riders:
            if not out[1, slot]:
                self._fail_nonfinite(slot, st, "decode")
                continue
            st.advance(int(out[0, slot]))
            self._finish_if_done(slot, st)

    def _spec_fault(self, where: str):
        """A fault at ``serving.draft``/``serving.verify``: the cycle
        degrades to plain decode, the riders lose only speed."""
        self.metrics.count("spec_faults")
        self.metrics.mark("spec_fault", where)

    def _spec_step(self):
        """One speculative cycle: draft, verify, then per slot accept the
        verify tokens while the drafts match them — the longest matching
        draft prefix plus one correction or bonus token, cut at the
        budget and at eos — so every accepted token is the one plain
        decode would give.  Rejected tokens rewind by not advancing; in
        the paged layout pages claimed past the accepted ones go back to
        the pool.  The ``serving.draft_logits`` poison is the draft
        program's float32 input, so its garbage proposals go through the
        real rejection path."""
        k = self.spec_tokens
        tok, pos, samp, riders = self._decode_rows()
        if not riders or all(st.remaining <= 1 for _s, st in riders):
            # every rider needs one more token: a window is overhead
            self._decode_step()
            return
        tr = _trace_active()
        tids = tuple(st.request.trace_id for _s, st in riders
                     if st.request.trace_id is not None)
        bad = _poison("serving.draft_logits")
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            # no riders: the draft degrades at once, never spending a
            # budget the mandatory verify or decode may need
            draft = self._run_draft(tok, pos, samp, pois=bad,
                                    site="serving.draft")
        except Exception:
            self._spec_fault("draft")
            self._decode_step()
            return
        if tr is not None:
            tr.record_span("serving.draft", t0, time.monotonic(),
                           trace_ids=tids, tokens=k)
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            draft, vt, ok = self._run_verify(tok, draft, pos, samp,
                                             site="serving.verify")
        except Exception:
            self._spec_fault("verify")
            self._decode_step()
            return
        if tr is not None:
            tr.record_span("serving.verify", t0, time.monotonic(),
                           trace_ids=tids, tokens=k + 1)
        self.metrics.count("spec_cycles")
        n_prop = n_acc = 0
        for slot, st in riders:
            if not ok[slot]:
                # the verify wrote the window's K/V: the NaN release
                # scrubs exactly the poisoned pages
                self._fail_nonfinite(slot, st, "decode")
                continue
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
        self.metrics.count("spec_tokens_proposed", n_prop)
        self.metrics.count("spec_tokens_accepted", n_acc)

    def _finish_if_done(self, slot: int, st: SlotState):
        if st.done or (st.request.eos_id is not None
                       and st.last_token == st.request.eos_id):
            self._release(slot)
            self._complete(st)

    def _complete(self, st: SlotState):
        req = st.request
        now = time.monotonic()
        t_first = st.t_first if st.t_first is not None else now
        self.metrics.observe_request(req.t_schedule - req.t_submit,
                                     t_first - req.t_schedule,
                                     now - t_first)
        self.metrics.count("completed")
        self.metrics.count_served(req.priority_name)
        self.metrics.count("tokens_generated", len(st.generated))
        self.metrics.count("decode_tokens_observed", len(st.generated))
        with self._lat_lock:
            self._ttft.append(req.t_first - req.t_submit)
            self._latency.append(now - req.t_submit)
        tr = _trace_active()
        if tr is not None and req.trace_id is not None:
            # retrospective phase spans, from the request's timestamps
            tr.record_span("serving.prefill_phase", req.t_schedule,
                           t_first, trace_id=req.trace_id)
            tr.record_span("serving.decode_phase", t_first, now,
                           trace_id=req.trace_id, tokens=len(st.generated))
            tr.record_span("serving.request", req.t_submit, now,
                           trace_id=req.trace_id, request=req.id)
            tr.event("serving.complete", trace_id=req.trace_id)
        req.future.set_result(np.concatenate(
            [req.payload, np.asarray(st.generated, np.int32)]))
