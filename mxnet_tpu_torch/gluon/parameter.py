"""Parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``).

Inside a model a parameter is a plain ``torch.nn.Parameter``.  Until
``initialize`` (or a load) gives it values it lives on the ``meta``
device: it has its shape and dtype but no storage, which is the port's
form of MXNet's deferred initialization — a full-width model is built
without touching host memory, then materialized once, on its device.

MXNet's :class:`Parameter` is a *handle* on one of them: the owning
module and the attribute, named by the structural name
(``h0.attn.q_proj.weight``).  ``data()`` and ``grad()`` are methods in
MXNet and attributes in torch, so the handle is not an ``nn.Parameter``
subclass: it returns NDArrays that alias the live tensor and its
``.grad`` buffer, and it keeps no state of its own.  ``grad_req``,
``lr_mult`` and ``wd_mult`` live on the tensor (``requires_grad`` and
``_mx_*`` attributes, which :meth:`Block._replace` carries across a
re-materialization), so every handle on a parameter agrees.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..initializer import Uniform
from ..ndarray.ndarray import NDArray, _numpy_dtype

__all__ = ["new_parameter", "is_initialized", "Parameter", "ParameterDict"]

# the tensor attributes a handle keeps its settings in
CARRIED_ATTRS = ("_mx_grad_req", "_mx_lr_mult", "_mx_wd_mult")


def new_parameter(shape, dtype=torch.float32) -> torch.nn.Parameter:
    """An uninitialized (meta-device) parameter of ``shape``/``dtype``."""
    return torch.nn.Parameter(
        torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                    device="meta"))


def is_initialized(p: torch.Tensor) -> bool:
    return p.device.type != "meta"


class Parameter:
    """Handle on parameter ``attr`` of ``module``, named ``name``."""

    def __init__(self, name, module, attr):
        self._name, self._module, self._attr = name, module, attr

    @property
    def name(self) -> str:
        return self._name

    @property
    def tensor(self) -> torch.nn.Parameter:
        """The live ``nn.Parameter`` (looked up on every use, so a handle
        follows ``initialize``, ``cast`` and loads)."""
        return self._module._parameters[self._attr]

    def __repr__(self):
        return f"Parameter {self._name} (shape={self.shape}, dtype={self.dtype})"

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    @property
    def dtype(self):
        return _numpy_dtype(self.tensor.dtype)

    # -- settings kept on the tensor ----------------------------------------
    @property
    def grad_req(self) -> str:
        t = self.tensor
        return getattr(t, "_mx_grad_req", "write") if t.requires_grad \
            else "null"

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be 'write', 'add' or 'null', "
                             f"not {req!r}")
        t = self.tensor
        t.requires_grad_(req != "null")
        t._mx_grad_req = req
        if req == "null":
            t.grad = None

    def _setting(self, key):
        return getattr(self.tensor, key, 1.0)

    lr_mult = property(lambda self: self._setting("_mx_lr_mult"),
                       lambda self, v: setattr(self.tensor, "_mx_lr_mult", v))
    wd_mult = property(lambda self: self._setting("_mx_wd_mult"),
                       lambda self, v: setattr(self.tensor, "_mx_wd_mult", v))

    # -- access ---------------------------------------------------------------
    def _live(self):
        t = self.tensor
        if not is_initialized(t):
            raise MXNetError(f"Parameter '{self._name}' has not been "
                             "initialized. Call .initialize() first")
        return t

    def data(self, ctx=None) -> NDArray:
        """The parameter as an NDArray sharing its storage: writes through
        it reach the model."""
        return NDArray(self._live(), alias=True)

    def grad(self, ctx=None) -> NDArray:
        """The gradient buffer as an NDArray sharing its storage (zeros
        until a backward writes it)."""
        t = self._live()
        if not t.requires_grad:
            raise MXNetError(f"Parameter '{self._name}' has grad_req='null'"
                             " — no gradient buffer")
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return NDArray(t.grad, alias=True)

    def zero_grad(self):
        t = self.tensor
        if t.grad is not None:
            t.grad.zero_()

    def set_data(self, data):
        """Copy ``data`` into the parameter (materializing it on the
        data's device if it was uninitialized)."""
        t = self.tensor
        src = data._t if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        if tuple(src.shape) != tuple(t.shape):
            raise MXNetError(f"Parameter '{self._name}': shape "
                             f"{tuple(src.shape)} does not match "
                             f"{tuple(t.shape)}")
        if not is_initialized(t):
            self._module._replace(self._module, self._attr,
                                  src.detach().to(t.dtype).clone(),
                                  t.requires_grad)
            return
        with torch.no_grad():
            t.copy_(src)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Draw the parameter on ``ctx`` (default: the current context)
        from ``mx.random``'s generator of that device."""
        t = self.tensor
        if is_initialized(t) and not force_reinit:
            return
        dev = resolve_device(ctx)
        new = torch.empty(t.shape, dtype=t.dtype, device=dev)
        with torch.no_grad():
            (init or default_init or Uniform()).init_tensor(
                self._name, new, _random.generator(dev))
        self._module._replace(self._module, self._attr, new, t.requires_grad)

    def cast(self, dtype):
        t = self.tensor
        self._module._replace(self._module, self._attr,
                              t.detach().to(torch_dtype(dtype)),
                              t.requires_grad)


class ParameterDict:
    """Ordered structural name → :class:`Parameter` mapping."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()

    @property
    def prefix(self):
        return self._prefix

    def __getitem__(self, name) -> Parameter:
        return self._params[name]

    def __contains__(self, name):
        return name in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def update(self, other):
        self._params.update(other._params if isinstance(other, ParameterDict)
                            else other)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self._params.values():
            p.initialize(default_init=init, ctx=ctx,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def save(self, filename, strip_prefix=""):
        """Write every parameter into an ``MXTPU1`` container."""
        from ..utils.serialization import save
        data = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            data[name] = p.data()._t
        save(filename, data)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Copy the arrays of an ``MXTPU1`` container into the parameters
        of the same names."""
        from ..utils.serialization import load
        loaded = {restore_prefix + k: v for k, v in load(filename).items()}
        for name, p in self._params.items():
            if name in loaded:
                p.set_data(torch.from_numpy(loaded[name]).to(
                    resolve_device(ctx) if not is_initialized(p.tensor)
                    else p.tensor.device))
            elif not allow_missing:
                raise MXNetError(f"Parameter {name} missing in file "
                                 f"{filename}")
        extra = set(loaded) - set(self._params)
        if extra and not ignore_extra:
            raise MXNetError(f"Extra parameters in {filename}: "
                             f"{sorted(extra)[:8]}")
