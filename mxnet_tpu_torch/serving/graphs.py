"""The serving engine's compiled programs: one CUDA graph per lattice
point (counterpart of the reference's jit cache and ``_counted``,
``mxnet_tpu/serving/engine.py:1388-1413``).

A :class:`Program` is one function of the engine at one lattice point,
keyed as the reference keys its programs: ``("decode",)``,
``("prefill", bb, tb)``, ``("chunk", bb, tb)``, ``("draft",)``,
``("verify",)``, ``("prefix_copy",)`` and ``("forward", bb) +
shape_key``.  It owns static device buffers for its inputs, shaped by
its first call.  A call copies its inputs in (host arrays through one
packed staging buffer, pinned on the card, and one host-to-device copy;
device tensors by ``copy_``) and returns the program's outputs.

On the card the first call runs the function once on a side stream
(library handles, workspaces and module loads happen outside the
capture), captures it into a ``torch.cuda.CUDAGraph`` on that stream,
into the memory pool the engine's programs share, and replays it; every
later call replays.  A program reads and writes the buffers it captured
(the engine's caches, its page table), so those are allocated before
the first capture and never again.  The shared pool is safe because the
engine replays one program at a time and reads each program's outputs
before the next replay.  A capture that fails raises
:class:`~.errors.ServingError` naming the program: there is no eager
fallback on the card.  Without graphs (the CPU, or an engine whose
private ``_graphs`` is False) the same function runs on the same static
buffers at every call.

The kernel wrappers count their launches in Python, and a replay runs
no Python: each program records the change of the registered counters
(``ops/launches.py``) during its capture and adds it at every replay,
so the counts still read kernel launches on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import launches as _launches
from .errors import ServingError

__all__ = ["Program"]

_ALIGN = 16


class Program:
    """One compiled program: ``fn`` over static input buffers shaped
    like ``args`` (numpy arrays or tensors on ``device``).  ``graph``
    captures a CUDA graph (on a CUDA device only) into ``pool`` on
    ``stream``; otherwise ``fn`` runs at every call."""

    def __init__(self, key, fn, args, device: torch.device,
                 graph: bool = False, pool=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.key = key
        self.fn = fn
        self.device = device
        self.graph = bool(graph) and device.type == "cuda"
        self._pool = pool
        self._stream = stream
        self._cuda_graph = None
        self._delta = {}
        self.outputs = None
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
        self.inputs, self._host_views, self._dev_inputs = [], [], []
        for a, off in zip(args, offs):
            if off is None:
                t = torch.empty_like(a, device=device)
                self._dev_inputs.append(t)
                self.inputs.append(t)
                continue
            start, dt, shape = off
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            self._host_views.append(
                host_np[start:start + n].view(dt).reshape(shape))
            tdt = torch.from_numpy(np.zeros((), dt)).dtype
            self.inputs.append(self._stage[start:start + n].view(tdt)
                               .view(shape))

    def _copy_in(self, args):
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
        for t, a in dev_args:
            t.copy_(a)

    def __call__(self, *args):
        self._copy_in(args)
        if self._cuda_graph is not None:
            self._cuda_graph.replay()
            _launches.add(self._delta)
        elif self.graph:
            self._capture()
        else:
            with torch.no_grad():
                self.outputs = self.fn(*self.inputs)
        return self.outputs

    def _capture(self):
        """Warm up on the capture stream, capture, replay once."""
        stream = self._stream
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream), torch.no_grad():
                self.fn(*self.inputs)
            cur.wait_stream(stream)
            before = _launches.snapshot()
            try:
                with torch.no_grad(), torch.cuda.graph(
                        graph, pool=self._pool, stream=stream,
                        capture_error_mode="thread_local"):
                    outputs = self.fn(*self.inputs)
            finally:
                # the capture launched nothing: keep its counts as the
                # replay's and put the counters back
                after = _launches.snapshot()
                self._delta = {k: n - before.get(k, 0)
                               for k, n in after.items()}
                _launches.add({k: -d for k, d in self._delta.items()})
        except Exception as e:
            raise ServingError(f"capturing program {self.key} failed: "
                               f"{type(e).__name__}: {e}") from e
        self._cuda_graph = graph
        self.outputs = outputs
        graph.replay()
        _launches.add(self._delta)
