"""``mx.monitor`` — intermediate-output monitoring for debugging
(counterpart of ``mxnet_tpu/monitor.py``).

Between ``tic()``/``toc()``, an installed Monitor records a statistic
(default ``|x|_1 / size``) of every op output whose name matches its
pattern.  It observes two places.  The op dispatcher
(``ndarray.ops.invoke``) reports every ``nd`` op by its name, so an
Executor's or a Module's graph reads as the reference's does
(``FullyConnected0``, ``Activation0``, ...).  The port's Gluon layers
compute on tensors without the dispatcher, so a module forward hook
reports each layer under the op its reference counterpart dispatches
(``_LAYER_OPS``: a ``Dense`` is ``FullyConnected``), one output per
layer (a ``Dense`` with ``activation=`` reports the activated output
once, where the reference reports the product and the activation).
Work inside a captured CUDA graph or a trace is not observable op by
op: run the model unhybridized while monitoring, as the reference
asks.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import numpy as onp
import torch

from .ndarray import NDArray

__all__ = ["Monitor", "nonfinite_stat"]

# the op each of the port's tensor-level layers stands for: the name the
# reference's layer dispatches
_LAYER_OPS = {
    "Dense": "FullyConnected", "Embedding": "Embedding",
    "Conv1D": "Convolution", "Conv2D": "Convolution",
    "Conv3D": "Convolution", "Conv1DTranspose": "Deconvolution",
    "Conv2DTranspose": "Deconvolution", "Conv3DTranspose": "Deconvolution",
    "BatchNorm": "BatchNorm", "LayerNorm": "LayerNorm",
    "GroupNorm": "GroupNorm", "InstanceNorm": "InstanceNorm",
    "Activation": "Activation", "Dropout": "Dropout", "Flatten": "Flatten",
    **{f"{kind}Pool{d}D": "Pooling" for kind in ("Max", "Avg", "GlobalMax",
                                                  "GlobalAvg")
       for d in (1, 2, 3)},
}


def _default_stat(x) -> onp.ndarray:
    return onp.abs(x).sum() / x.size


def nonfinite_stat(x) -> onp.ndarray:
    """Fast-path health stat: the COUNT of non-finite (NaN/Inf) elements
    — 0 for a clean tensor.  One vectorized ``isfinite`` pass, no
    reductions beyond a popcount, so it is cheap enough to leave
    installed while hunting the block that first emits a NaN
    (docs/guardrails.md: provenance for a tripped guardrail)."""
    x = onp.asarray(x)
    if not onp.issubdtype(x.dtype, onp.floating) and \
            not onp.issubdtype(x.dtype, onp.complexfloating):
        return onp.int64(0)          # integer tensors cannot go non-finite
    return onp.int64(x.size - onp.count_nonzero(onp.isfinite(x)))


class Monitor:
    """Collect a statistic of matching op outputs between tic()/toc().

    Parameters
    ----------
    interval : record every N-th batch (tic/toc pairs)
    stat_func : ndarray -> scalar statistic (default mean |x|)
    pattern : regex on op names
    sort : sort toc() results by name
    """

    def __init__(self, interval: int = 1,
                 stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue: List[Tuple[int, str, onp.ndarray]] = []
        self._installed = False
        self._counts = {}

    # ------------------------------------------------------------- hooks
    def _hook(self, name, outputs):
        if not self.activated or not self.re_pattern.match(name):
            return
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            return                 # inside a capture: not observable
        i = self._counts.get(name, 0)
        self._counts[name] = i + 1
        for j, out in enumerate(outputs):
            key = f"{name}{i}" + (f"_output{j}" if len(outputs) > 1 else "")
            try:
                self.queue.append(
                    (self.step, key,
                     onp.asarray(self.stat_func(out.asnumpy()))))
            except Exception:
                pass               # stat errors must never kill the op

    def _layer_hook(self, module, args, output):
        name = _LAYER_OPS.get(type(module).__name__)
        if name is None or not isinstance(output, torch.Tensor):
            return
        self._hook(name, [NDArray(output.detach())])

    @classmethod
    def nonfinite(cls, interval: int = 1, pattern: str = ".*",
                  sort: bool = False) -> "Monitor":
        """A Monitor preconfigured with :func:`nonfinite_stat`: every
        matching op output reports its non-finite element count, so the
        first entry with a non-zero stat names the block where a NaN/Inf
        was born (run un-hybridized, like any Monitor session)."""
        return cls(interval=interval, stat_func=nonfinite_stat,
                   pattern=pattern, sort=sort)

    def first_nonfinite(self, results=None):
        """From a ``toc()`` result list (or the live queue), the first
        ``(step, name, stat)`` whose stat is non-zero — the provenance
        answer "which op went bad first" — or ``None`` if all clean."""
        for entry in (self.queue if results is None else results):
            if float(entry[2]) != 0.0:
                return entry
        return None

    @property
    def installed(self) -> bool:
        return self._installed

    def install(self):
        """Start observing (Module.install_monitor calls this): the op
        dispatcher's hook and a forward hook on every module.
        Idempotent: a second install never double-registers."""
        from .ndarray import ops as _ops
        if not self._installed:
            _ops._invoke_hooks.append(self._hook)
            self._layer_handle = \
                torch.nn.modules.module.register_module_forward_hook(
                    self._layer_hook)
            self._installed = True
        return self

    def uninstall(self):
        """Stop observing; exact inverse of :meth:`install` (idempotent,
        leaves foreign hooks untouched)."""
        from .ndarray import ops as _ops
        if self._installed:
            _ops._invoke_hooks.remove(self._hook)
            self._layer_handle.remove()
            self._installed = False
        return self

    # ------------------------------------------------------------ control
    def tic(self):
        """Start collecting for this batch (every ``interval``-th)."""
        if self.step % self.interval == 0:
            self.queue = []
            self._counts = {}
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, onp.ndarray]]:
        """Stop collecting; return [(step, name, stat)]."""
        if not self.activated:
            return []
        self.activated = False
        res = self.queue
        self.queue = []
        if self.sort:
            res = sorted(res, key=lambda t: t[1])
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            print(f"Batch: {step:7d} {name:30s} {stat}")

    def __enter__(self):
        self.install()
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc_print()
        self.uninstall()
