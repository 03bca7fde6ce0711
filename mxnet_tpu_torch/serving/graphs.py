"""The serving engine's compiled programs: one CUDA graph per lattice
point (counterpart of the reference's jit cache and ``_counted``,
``mxnet_tpu/serving/engine.py:1388-1413``).

A :class:`Program` is one function of the engine at one lattice point,
keyed as the reference keys its programs: ``("decode",)``,
``("prefill", bb, tb)``, ``("chunk", bb, tb)``, ``("draft",)``,
``("verify",)``, ``("prefix_copy",)`` and ``("forward", bb) +
shape_key``.  It owns static device buffers for its inputs, shaped by
its first call, and a call copies its inputs in and returns the
program's outputs (both through ``utils/graphs.py``'s ``Program``).

On the card the first call runs the function once on a side stream,
captures it into the memory pool the engine's programs share, and
replays it; every later call replays.  A program reads and writes the
buffers it captured (the engine's caches, its page table), so those are
allocated before the first capture and never again.  The shared pool is
safe because the engine replays one program at a time and reads each
program's outputs before the next replay.  A capture that fails raises
:class:`~.errors.ServingError` naming the program: there is no eager
fallback on the card.  Without graphs (the CPU, or an engine whose
private ``_graphs`` is False) the same function runs on the same static
buffers at every call.  A replay adds the launches its capture recorded
to the kernel wrappers' counters.  A hybridized block the function calls
runs inline, as everywhere inside a program.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import graphs as _graphs
from .errors import ServingError

__all__ = ["Program"]


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
        self.outputs = None
        self._prog = _graphs.Program(args, device, graph, self._failed,
                                     pool=pool, stream=stream)
        self.graph = self._prog.graphed
        self.inputs = self._prog.inputs

    def _failed(self, e):
        return ServingError(f"capturing program {self.key} failed: "
                            f"{type(e).__name__}: {e}")

    def _run(self):
        with torch.no_grad():
            return self.fn(*self.inputs)

    def __call__(self, *args):
        prog = self._prog
        prog.copy_in(args)
        if not self.graph:
            self.outputs = prog.run(self._run)
        elif prog.built:
            prog.replay()
        else:
            self.outputs, = prog.build(self._run, self._run)
            prog.replay()
        return self.outputs
