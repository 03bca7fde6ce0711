"""Block / HybridBlock on ``torch.nn.Module`` (counterpart of
``mxnet_tpu/gluon/block.py``).

Structural parameter names are the reference's (``gluon/block.py:111``):
a parameter is named by its attribute path, ``h0.attn.q_proj.weight``,
which is exactly what ``nn.Module.named_parameters`` yields for the same
tree.  Those names key ``save_parameters``/``load_parameters`` and
:func:`mxnet_tpu_torch.utils.convert.load_numpy_params`, so one
parameter file serves both packages.  The port runs eagerly: there is no
hybridize or CachedOp.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..initializer import Uniform
from .parameter import is_initialized, new_parameter

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

    def collect_params(self) -> "OrderedDict[str, torch.nn.Parameter]":
        """Structural name → parameter, in registration order."""
        return OrderedDict((name, m._parameters[attr])
                           for name, m, attr in self._param_slots())

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
        """Rebind parameter ``attr`` of module ``m`` to tensor ``t``."""
        m._parameters[attr] = torch.nn.Parameter(t,
                                                 requires_grad=requires_grad)

    def initialize(self, init=None, device=None, seed: int = 0,
                   force_reinit: bool = False):
        """Give every uninitialized parameter values on ``device`` (the
        construction device, else the current CUDA device), drawn by
        ``init`` (default ``Uniform(0.07)``) from a ``torch.Generator``
        seeded with ``seed``, in structural-name order."""
        dev = self._target_device(device)
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
        params = self.collect_params()
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
    port runs it eagerly."""
