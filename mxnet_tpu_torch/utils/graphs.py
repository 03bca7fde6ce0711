"""CUDA graphs: the static buffers, capture and replay that every
compiled form of the port shares (the counterpart of the reference's
``jax.jit`` caches): the serving engine's programs
(``serving/graphs.py``), a hybridized block's CachedOp
(``gluon/cached_op.py``) and ``ShardedTrainer``'s step
(``parallel/trainer.py``) are each a :class:`Program`.

:class:`Program` is one compiled program: its static inputs, and either
its function run at every call (the CPU, or a caller's eager arm) or,
on the card, a warm-up on the capture stream, the capture of one or
more stages into graphs of one memory pool, and their replays.  Every
run of a program's function, warm-up and captures included, happens
:func:`inside` the program, so a hybridized block met there runs inline
(as jax inlines a jitted call into an enclosing trace) on either device.

:class:`StaticInputs` owns a compiled function's input buffers on the
device, shaped by its first call.  A call copies its inputs in: host
arrays through one packed staging buffer (pinned on the card) and one
host-to-device copy, device tensors by ``copy_``.

:class:`Graph` captures a function of no arguments, which reads and
writes static buffers, into a ``torch.cuda.CUDAGraph``: a warm-up run on
the capture stream first where the caller wants one (library handles,
workspaces and module loads then happen outside the capture), then the
capture into the given memory pool, with ``capture_error_mode=
"thread_local"`` (autograd's device thread runs a captured backward).
Generators given to it are registered with the graph, so each replay
draws fresh numbers from them.  The cyclic garbage collector runs before
a capture and not during it: a graph that died during another's capture
would free its memory there, which invalidates the capture.  A host
read, an allocation the pool cannot serve, or a generator that is not
registered makes the capture raise; the caller names what failed and
never runs the function eagerly instead.  A capture that fails leaves
its generators as it found them: torch takes a generator out of capture
mode only where a capture ends well, so after a failure an empty capture
of the same generators (the device's default one included) does it.

The kernel wrappers count their launches in Python, and a replay runs
no Python: a graph records the change of the registered counters
(``ops/launches.py``) during its capture, puts the counters back (the
capture launched nothing), and adds the change at every replay, so the
counts still read kernel launches on the card.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import launches as _launches

__all__ = ["StaticInputs", "Graph", "Program", "on_stream", "inside",
           "in_program", "compile_enabled", "set_compile"]

_ALIGN = 16
_RUNNING = threading.local()
# the process-wide switch ``mx.util.disable_jit`` turns: while off, a
# hybridized block runs its forward imperatively (the reference's
# ``jax_disable_jit``, under which a jitted call runs op by op)
_COMPILE = [True]


def compile_enabled() -> bool:
    return _COMPILE[0]


def set_compile(flag: bool) -> bool:
    """Turn hybridize's compiled programs on or off; returns the
    previous setting."""
    prev, _COMPILE[0] = _COMPILE[0], bool(flag)
    return prev


@contextlib.contextmanager
def inside():
    """Mark this thread as running a program's function."""
    prev = getattr(_RUNNING, "on", False)
    _RUNNING.on = True
    try:
        yield
    finally:
        _RUNNING.on = prev


def in_program() -> bool:
    """Whether this thread runs a program's function (a hybridized block
    met there runs inline)."""
    return getattr(_RUNNING, "on", False)


class StaticInputs:
    """Static device buffers for inputs shaped like ``args`` (numpy
    arrays or tensors) on ``device``: ``buffers`` in the order of
    ``args``."""

    def __init__(self, args, device: torch.device):
        self.device = device
        offs, total = [], 0
        for a in args:
            if isinstance(a, torch.Tensor):
                offs.append(None)
                continue
            a = np.asarray(a)
            offs.append((total, a.dtype, a.shape))
            total += -(-max(a.nbytes, 1) // _ALIGN) * _ALIGN
        pin = device.type == "cuda"
        self._host = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                                 pin_memory=pin)
        self._stage = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                                  device=device)
        self._staged = total > 0
        self._copied = None       # the last staging copy's event
        host_np = self._host.numpy()
        self.buffers, self._host_views, self._dev_inputs = [], [], []
        for a, off in zip(args, offs):
            if off is None:
                t = torch.empty_like(a, device=device)
                self._dev_inputs.append(t)
                self.buffers.append(t)
                continue
            start, dt, shape = off
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            self._host_views.append(
                host_np[start:start + n].view(dt).reshape(shape))
            tdt = torch.from_numpy(np.zeros((), dt)).dtype
            self.buffers.append(self._stage[start:start + n].view(tdt)
                                .view(shape))

    def copy_in(self, args):
        """Write ``args`` (shaped as at construction) into the buffers,
        on the current stream, with no host wait but for the previous
        staging copy."""
        if self._copied is not None:
            # the host buffer may still be feeding the last copy
            self._copied.synchronize()
        hv = iter(self._host_views)
        dv = iter(self._dev_inputs)
        dev_args = []
        for a in args:
            if isinstance(a, torch.Tensor):
                dev_args.append((next(dv), a))
            else:
                next(hv)[...] = a
        if self._staged:
            self._stage.copy_(self._host, non_blocking=True)
            if self.device.type == "cuda":
                self._copied = torch.cuda.Event()
                self._copied.record()
        with torch.no_grad():
            for t, a in dev_args:
                t.copy_(a)


def on_stream(stream: "torch.cuda.Stream", fn):
    """``fn()`` run eagerly on ``stream`` (a capture stream), ordered
    after the current stream's work and before its later work."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    try:
        with torch.cuda.stream(stream), inside():
            return fn()
    finally:
        cur.wait_stream(stream)


class Graph:
    """One CUDA graph on ``device``, captured into ``pool`` (a
    ``torch.cuda.graph_pool_handle()``; a new one by default) on
    ``stream`` (a new side stream by default), with ``generators``
    registered."""

    def __init__(self, device: torch.device, pool=None,
                 stream: Optional["torch.cuda.Stream"] = None,
                 generators: Sequence[torch.Generator] = ()):
        self.device = device
        self.pool = pool if pool is not None else \
            torch.cuda.graph_pool_handle()
        self.stream = stream if stream is not None else \
            torch.cuda.Stream(device)
        self.generators = list(generators)
        self._graph = None
        self._delta = {}

    def capture(self, fn):
        """Capture ``fn()`` (launching nothing) and return what it
        returned: the static outputs a replay rewrites."""
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = _launches.snapshot()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"), \
                    inside():
                out = fn()
        except BaseException:
            del graph
            self._end_capture_mode()
            raise
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing: keep its counts as the
            # replay's and put the counters back
            after = _launches.snapshot()
            delta = {k: n - before.get(k, 0) for k, n in after.items()}
            _launches.add({k: -d for k, d in delta.items()})
        self._graph, self._delta = graph, delta
        return out

    def _end_capture_mode(self):
        """Take the generators out of capture mode after a failed
        capture (otherwise every later draw from them outside a capture
        raises): an empty capture of them, whose end runs torch's
        epilogue for each."""
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # the graph is empty
            with torch.cuda.device(self.device), \
                    torch.cuda.graph(graph, stream=torch.cuda.Stream(
                        self.device), capture_error_mode="thread_local"):
                pass

    def replay(self):
        """Run the captured work on the current stream's device and
        credit the launches it holds."""
        self._graph.replay()
        _launches.add(self._delta)


class Program:
    """One compiled program over static inputs shaped like ``args`` on
    ``device``.  Without graphs (``graphed`` False, or a device that is
    not CUDA) the caller runs its function at every call (:meth:`run`).
    With graphs, :meth:`build` captures it once and :meth:`replay` runs
    it: the graphs share ``pool`` and ``stream`` (new ones by default).
    ``draws`` (a :class:`~mxnet_tpu_torch.random.GraphDraws`, or None)
    holds the generator states every graph registers and the remat
    twins aligned before each replay.  A build that fails raises
    ``fail(exc)``, the caller's error naming the program."""

    def __init__(self, args, device: torch.device, graphed, fail, pool=None,
                 stream: Optional["torch.cuda.Stream"] = None, draws=None):
        self.static = StaticInputs(args, device)
        self.inputs = self.static.buffers
        self.device = device
        self.graphed = bool(graphed) and device.type == "cuda"
        self.fail = fail
        self.pool, self.stream, self.draws = pool, stream, draws
        self.graphs = []

    def copy_in(self, args):
        self.static.copy_in(args)

    @staticmethod
    def run(fn, *args):
        """``fn(*args)`` as the program's function, eagerly."""
        with inside():
            return fn(*args)

    @property
    def built(self) -> bool:
        return bool(self.graphs)

    def _drawing(self, frozen=False):
        return contextlib.nullcontext() if self.draws is None else \
            self.draws.building(frozen=frozen)

    def build(self, warm, *stages):
        """Run ``warm()`` once eagerly on the capture stream (it must
        leave the state it found), then capture each of ``stages`` in
        turn into a graph of its own, each called with the previous
        stage's result (the first with nothing).  Returns the stages'
        results: the static outputs their replays rewrite."""
        stream = self.stream if self.stream is not None else \
            torch.cuda.Stream(self.device)
        pool, graphs, results = self.pool, [], []
        try:
            with self._drawing():
                on_stream(stream, warm)
            gens = self.draws.generators() if self.draws is not None else ()
            for stage in stages:
                g = Graph(self.device, pool=pool, stream=stream,
                          generators=gens)
                prev = results[-1:]
                with self._drawing(frozen=True):
                    results.append(g.capture(lambda: stage(*prev)))
                pool = g.pool
                graphs.append(g)
        except Exception as e:
            raise self.fail(e) from e
        self.graphs = graphs
        return results

    def replay(self, stage=0, offsets=None):
        """Replay ``stage``'s graph, the remat twins aligned first (to
        ``offsets``, as ``draws.offsets()`` read them; default now)."""
        if self.draws is not None:
            self.draws.align(offsets)
        self.graphs[stage].replay()
