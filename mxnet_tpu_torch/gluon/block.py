"""Block / HybridBlock on ``torch.nn.Module`` (counterpart of
``mxnet_tpu/gluon/block.py``).

Structural parameter names are the reference's (``gluon/block.py:111``):
a parameter is named by its attribute path, ``h0.attn.q_proj.weight``,
which is exactly what ``nn.Module.named_parameters`` yields for the same
tree.  Those names key ``save_parameters``/``load_parameters``,
:func:`mxnet_tpu_torch.utils.convert.load_numpy_params` and
:meth:`Block.collect_params` (a ``ParameterDict`` of handles; the tensor
view is torch's own ``named_parameters()``), so one parameter file
serves both packages.  The port runs eagerly: there is no hybridize or
CachedOp.

A Block has two calling conventions.  Tensors in, tensors out: torch's
own semantics, which ``ShardedTrainer``, ``InferenceEngine`` and the
models use.  NDArrays in, NDArrays out: MXNet's, where the call builds a
graph only inside ``autograd.record()``.  A :class:`HybridBlock` that
defines ``hybrid_forward(self, F, x, ...)`` runs it with ``F = mx.nd``
and its parameters as NDArrays, under either convention.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from .. import base as _base
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..initializer import Uniform
from ..ndarray.ndarray import NDArray
from .parameter import (CARRIED_ATTRS, Parameter, ParameterDict,
                        is_initialized, new_parameter)

__all__ = ["Block", "HybridBlock"]


class Block(torch.nn.Module):
    """Base class for all layers and models."""

    def __init__(self):
        super().__init__()
        # device chosen at construction (get_gpt2(device=...)); None
        # means "resolve at initialize time"
        self._device: Optional[torch.device] = None

    def _new_param(self, attr: str, shape, dtype=torch.float32):
        p = new_parameter(shape, dtype)
        self.register_parameter(attr, p)
        return p

    def _param_slots(self):
        """(structural name, owning module, attribute) per parameter,
        in registration order."""
        for mname, m in self.named_modules():
            for attr, p in m._parameters.items():
                if p is not None:
                    yield (f"{mname}.{attr}" if mname else attr), m, attr

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """Structural name → :class:`Parameter` handle, in registration
        order; ``select`` keeps the names a regex matches."""
        rx = re.compile(select) if select else None
        out = ParameterDict()
        out.update({name: Parameter(name, m, attr)
                    for name, m, attr in self._param_slots()
                    if rx is None or rx.match(name)})
        return out

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, NDArray) for a in (*args,
                                                    *kwargs.values())):
            return super().__call__(*args, **kwargs)
        with torch.set_grad_enabled(_base.is_recording()):
            out = super().__call__(*_unwrap(args), **_unwrap(kwargs))
        return _wrap(out)

    @property
    def device(self) -> Optional[torch.device]:
        """Where the parameters live (the construction device while they
        are uninitialized)."""
        for p in self.parameters():
            if is_initialized(p):
                return p.device
        return self._device

    def _target_device(self, device=None) -> torch.device:
        return resolve_device(device if device is not None
                              else self._device)

    @staticmethod
    def _replace(m, attr, t, requires_grad):
        """Rebind parameter ``attr`` of module ``m`` to tensor ``t``,
        keeping the handle settings (``grad_req``, multipliers)."""
        old = m._parameters[attr]
        new = torch.nn.Parameter(t, requires_grad=requires_grad)
        for key in CARRIED_ATTRS:
            if hasattr(old, key):
                setattr(new, key, getattr(old, key))
        m._parameters[attr] = new

    def initialize(self, init=None, device=None, seed: int = 0,
                   force_reinit: bool = False, ctx=None):
        """Give every uninitialized parameter values on ``device`` (or
        MXNet's ``ctx``; default: the construction device, else the
        current context), drawn by ``init`` (default ``Uniform(0.07)``)
        from a ``torch.Generator`` seeded with ``seed``, in
        structural-name order."""
        dev = self._target_device(device if device is not None else ctx)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        init = init or Uniform()
        with torch.no_grad():
            for name, m, attr in self._param_slots():
                p = m._parameters[attr]
                if is_initialized(p) and not force_reinit:
                    continue
                t = torch.empty(p.shape, dtype=p.dtype, device=dev)
                init.init_tensor(name, t, gen)
                self._replace(m, attr, t, p.requires_grad)
        self._device = dev
        return self

    def cast(self, dtype):
        """Cast every parameter (initialized or not) to ``dtype``; caches
        the serving surface builds follow it."""
        dt = torch_dtype(dtype)
        with torch.no_grad():
            for _name, m, attr in self._param_slots():
                p = m._parameters[attr]
                self._replace(m, attr, p.detach().to(dt), p.requires_grad)
        return self

    def save_parameters(self, filename: str):
        """Write every parameter under its structural name into an
        ``MXTPU1`` container."""
        from ..utils.serialization import save
        params = dict(self.named_parameters(remove_duplicate=False))
        for k, p in params.items():
            if not is_initialized(p):
                raise MXNetError(f"Parameter '{k}' has not been "
                                 "initialized")
        save(filename, params)

    def load_parameters(self, filename: str, device=None):
        """Load an ``MXTPU1`` container written by either package."""
        from ..utils.convert import load_numpy_params
        from ..utils.serialization import load
        return load_numpy_params(self, load(filename), device=device)


class HybridBlock(Block):
    """A Block the reference could compile into one XLA program; the
    port runs it eagerly.  A subclass defines ``forward`` over tensors,
    or ``hybrid_forward(self, F, x, *args, **params)`` over NDArrays."""

    def forward(self, *args, **kwargs):
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError(f"{type(self).__name__} must "
                                      "implement forward or hybrid_forward")
        from .. import ndarray as nd
        params = {attr: NDArray(p, alias=True)
                  for attr, p in self._parameters.items() if p is not None}
        # tensors arrive here under the caller's grad mode, which the
        # NDArray ops below keep by reading it as the recording flag
        prev = _base.set_recording(torch.is_grad_enabled())
        try:
            out = self.hybrid_forward(nd, *_wrap(args), **_wrap(kwargs),
                                      **params)
        finally:
            _base.set_recording(prev)
        return _unwrap(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _wrap(x):
    """Tensors (alone or in a tuple, list or dict) as NDArrays."""
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _wrap(v) for k, v in x.items()}
    return x


def _unwrap(x):
    """NDArrays (alone or in a tuple, list or dict) as their tensors."""
    if isinstance(x, NDArray):
        return x._t
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x
