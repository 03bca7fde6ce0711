"""Parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``).

Inside a model a parameter is a plain ``torch.nn.Parameter``.  Until
``initialize`` (or a load) gives it values it lives on the ``meta``
device: it has its shape and dtype but no storage, so a full-width
model is built without touching host memory, then materialized once, on
its device.  A declared dimension of 0 is unknown, as in MXNet: such a
parameter is *deferred* — ``initialize`` records its initializer and
device, and the owning block's first call infers the shape from its
input (``Block.infer_shape``) and draws the values on the recorded
device, or on the input's when none was given.  A meta parameter never
reaches an op.

MXNet's :class:`Parameter` is a *handle* on one of them: the owning
module and the attribute, named by the structural name
(``h0.attn.q_proj.weight``).  ``data()`` and ``grad()`` are methods in
MXNet and attributes in torch, so the handle is not an ``nn.Parameter``
subclass: it returns NDArrays that alias the live tensor and its
``.grad`` buffer, and it keeps no state of its own.  Its settings —
``grad_req``, ``lr_mult``, ``wd_mult``, the initializer attached to it,
whether it may defer — live on the tensor (``requires_grad`` and
``_mx_*`` attributes, which :func:`replace_parameter` carries across a
re-materialization), so every handle on a parameter agrees.  A
standalone ``Parameter(name, shape=...)`` owns a private holder module;
assigning it to a block attribute moves the tensor into the block.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import initializer as init_mod
from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..context import Context, _scope, resolve_device
from ..ndarray.ndarray import NDArray, _numpy_dtype, sparse_grad_buffer

__all__ = ["DeferredInitializationError", "new_parameter", "is_initialized",
           "shape_known", "replace_parameter", "Parameter", "Constant",
           "ParameterDict"]

# the tensor attributes a parameter keeps its settings in
CARRIED_ATTRS = ("_mx_grad_req", "_mx_lr_mult", "_mx_wd_mult", "_mx_init",
                 "_mx_allow_deferred", "_logical_axes", "_mx_stype",
                 "_mx_grad_stype")
STYPES = ("default", "row_sparse", "csr")


class DeferredInitializationError(MXNetError):
    """A parameter's shape is still unknown: call the block with data."""


class _Deferred:
    """What ``initialize`` decided for a parameter of unknown shape: the
    initializer, whether it was attached to the parameter itself, the
    device (None: the input's), and where its draws come from (a
    callable device → ``torch.Generator``)."""

    __slots__ = ("init", "explicit", "device", "draws")

    def __init__(self, init, explicit, device, draws):
        self.init, self.explicit = init, explicit
        self.device, self.draws = device, draws


class SeededDraws:
    """One seeded ``torch.Generator`` per device, shared by every
    parameter of one ``initialize`` call, so draws follow the order the
    parameters materialize in."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._gens = {}

    def __call__(self, device: torch.device) -> torch.Generator:
        g = self._gens.get(device)
        if g is None:
            g = self._gens[device] = torch.Generator(device=device)
            g.manual_seed(self.seed)
        return g


def new_parameter(shape, dtype=torch.float32, *, init=None,
                  allow_deferred_init=False, grad_req="write",
                  stype="default",
                  grad_stype="default") -> torch.nn.Parameter:
    """An uninitialized (meta-device) parameter of ``shape``/``dtype``;
    a dimension of 0 is unknown until the first forward.  ``init`` (an
    initializer or its name) is attached to the parameter and wins over
    the name rule.  ``grad_stype='row_sparse'`` gives it a compact
    gradient buffer (``RowSparseNDArray``); ``stype`` is recorded, the
    weight itself stays dense (as the reference's)."""
    for st in (stype, grad_stype):
        if st not in STYPES:
            raise MXNetError(f"unknown storage type {st!r}")
    p = torch.nn.Parameter(
        torch.empty(tuple(int(s) for s in shape), dtype=torch_dtype(dtype),
                    device="meta"), requires_grad=grad_req != "null")
    if grad_req != "write":
        p._mx_grad_req = grad_req
    if init is not None:
        p._mx_init = init_mod.create(init)
    if allow_deferred_init:
        p._mx_allow_deferred = True
    if stype != "default":
        p._mx_stype = stype
    if grad_stype != "default":
        p._mx_grad_stype = grad_stype
    return p


def is_initialized(p: torch.Tensor) -> bool:
    return p.device.type != "meta"


def shape_known(p: torch.Tensor) -> bool:
    return all(s > 0 for s in p.shape)


def replace_parameter(m, attr, t, requires_grad):
    """Rebind parameter ``attr`` of module ``m`` to tensor ``t``, keeping
    the settings kept on the old tensor (``grad_req``, multipliers, the
    attached initializer)."""
    old = m._parameters[attr]
    new = torch.nn.Parameter(t, requires_grad=requires_grad)
    for key in CARRIED_ATTRS:
        if hasattr(old, key):
            setattr(new, key, getattr(old, key))
    m._parameters[attr] = new
    return new


def _compatible(declared, shape) -> bool:
    """Whether ``shape`` fills ``declared``, whose 0 dims are unknown."""
    return len(declared) == len(shape) and all(
        d == 0 or d == s for d, s in zip(declared, shape))


def set_shape(m, attr, shape):
    """Give parameter ``attr`` of ``m`` its inferred ``shape``; the known
    dimensions must agree (the reference's ``_set_shape``)."""
    p = m._parameters[attr]
    shape = tuple(int(s) for s in shape)
    if tuple(p.shape) == shape:
        return
    if not (getattr(p, "_mx_shape_unset", False)
            or _compatible(tuple(p.shape), shape)):
        raise ValueError(f"Parameter {attr}: inferred shape {shape} "
                         f"incompatible with declared {tuple(p.shape)}")
    pending = getattr(p, "_mx_deferred", None)
    new = replace_parameter(m, attr, torch.empty(shape, dtype=p.dtype,
                                                 device="meta"),
                            p.requires_grad)
    if pending is not None:
        new._mx_deferred = pending


def materialize(name, m, attr, initializer, explicit, device, generator):
    """Draw parameter ``attr`` of ``m`` (known shape) on ``device``."""
    p = m._parameters[attr]
    t = torch.empty(p.shape, dtype=p.dtype, device=device)
    with torch.no_grad():
        initializer.init_tensor(name, t, generator, explicit=explicit)
    replace_parameter(m, attr, t, p.requires_grad)


def defer(m, attr, initializer, explicit, device, draws):
    """Record what ``initialize`` decided for a parameter whose shape is
    still unknown (or a sibling of one); the owning block finishes it at
    its first call."""
    p = m._parameters[attr]
    if not shape_known(p) and not getattr(p, "_mx_allow_deferred", False):
        raise ValueError(f"Cannot initialize Parameter {attr}: shape "
                         f"{tuple(p.shape)} unknown and deferred init not "
                         "allowed")
    p._mx_deferred = _Deferred(initializer, explicit, device, draws)
    if hasattr(m, "_deferred_pending"):
        m._deferred_pending = True


def finish_deferred(name, m, attr, device=None):
    """Materialize a deferred parameter on its recorded device, else on
    ``device`` (the input's)."""
    p = m._parameters[attr]
    rec = getattr(p, "_mx_deferred", None)
    if rec is None:
        return
    if not shape_known(p):
        raise DeferredInitializationError(
            f"Parameter {name} shape {tuple(p.shape)} still unknown")
    dev = rec.device if rec.device is not None else device
    if dev is None:
        raise DeferredInitializationError(
            f"Parameter {name}: no device to materialize it on")
    materialize(name, m, attr, rec.init, rec.explicit, dev, rec.draws(dev))


def deferred_device(device=None, construction=None):
    """Where a deferred parameter will live: the device given, else the
    block's construction device, else the enclosing ``with ctx:``
    scope's, else None (the first input's)."""
    if device is not None:
        return resolve_device(device)
    if construction is not None:
        return construction
    scope = _scope()
    return scope.torch_device if scope is not None else None


class Parameter:
    """A parameter handle (MXNet's ``gluon.Parameter``).

    ``Parameter(name, shape=..., init=..., dtype=..., grad_req=...,
    allow_deferred_init=...)`` makes a standalone parameter, which a
    block adopts when it is assigned to one of its attributes;
    :meth:`Block.collect_params` hands out handles on the parameters a
    block already has."""

    def __init__(self, name="weight", grad_req="write", shape=None,
                 dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        holder = torch.nn.Module()
        p = new_parameter(() if shape is None else shape, dtype, init=init,
                          allow_deferred_init=allow_deferred_init,
                          grad_req=grad_req if differentiable else "null",
                          stype=stype, grad_stype=grad_stype)
        if shape is None:
            p._mx_shape_unset = True
        holder.register_parameter("value", p)
        self._name, self._module, self._attr = name, holder, "value"
        if lr_mult != 1.0:
            self.lr_mult = lr_mult
        if wd_mult != 1.0:
            self.wd_mult = wd_mult

    @classmethod
    def _handle(cls, name, module, attr) -> "Parameter":
        """A handle on parameter ``attr`` of ``module``."""
        h = cls.__new__(cls)
        h._name, h._module, h._attr = name, module, attr
        return h

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
        t = self.tensor
        return None if getattr(t, "_mx_shape_unset", False) else \
            tuple(t.shape)

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

    @property
    def stype(self) -> str:
        return getattr(self.tensor, "_mx_stype", "default")

    @property
    def grad_stype(self) -> str:
        return getattr(self.tensor, "_mx_grad_stype", "default")

    lr_mult = property(lambda self: self._setting("_mx_lr_mult"),
                       lambda self, v: setattr(self.tensor, "_mx_lr_mult", v))
    wd_mult = property(lambda self: self._setting("_mx_wd_mult"),
                       lambda self, v: setattr(self.tensor, "_mx_wd_mult", v))

    # -- access ---------------------------------------------------------------
    def _live(self):
        t = self.tensor
        if not is_initialized(t):
            if getattr(t, "_mx_deferred", None) is not None:
                raise DeferredInitializationError(
                    f"Parameter '{self._name}' pending deferred init — "
                    "call the block with data first")
            raise MXNetError(f"Parameter '{self._name}' has not been "
                             "initialized. Call .initialize() first")
        return t

    def data(self, ctx=None) -> NDArray:
        """The parameter as an NDArray sharing its storage: writes through
        it reach the model."""
        return NDArray(self._live(), alias=True)

    def list_data(self):
        return [self.data()]

    @property
    def var(self):
        """The symbol-API hook: the parameter itself, as the
        reference's ``Parameter.var`` gives."""
        return self

    def grad(self, ctx=None) -> NDArray:
        """The gradient buffer as an NDArray sharing its storage (zeros
        until a backward writes it)."""
        t = self._live()
        if not t.requires_grad:
            raise MXNetError(f"Parameter '{self._name}' has grad_req='null'"
                             " — no gradient buffer")
        if self.grad_stype == "row_sparse":
            return sparse_grad_buffer(t)
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return NDArray(t.grad, alias=True)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        t = self.tensor
        return [Context(t.device)] if is_initialized(t) else []

    def zero_grad(self):
        """Zero the gradient buffer; a row-sparse one keeps no rows (it
        stays compact)."""
        t = self.tensor
        h = getattr(t, "_mx_rsp_grad", None)
        if h is not None:
            h._set_components(
                torch.zeros((0,) + tuple(t.shape[1:]), dtype=t.dtype,
                            device=t.device),
                torch.zeros((0,), dtype=torch.int64, device=t.device))
            h._sp_shape = tuple(t.shape)
        if t.grad is not None:
            t.grad.zero_()

    def set_data(self, data):
        """Copy ``data`` into the parameter; an uninitialized one takes
        the data's shape (where its own is unknown) and device."""
        t = self.tensor
        src = data._t if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        if not is_initialized(t):
            if not (getattr(t, "_mx_shape_unset", False)
                    or _compatible(tuple(t.shape), tuple(src.shape))):
                raise MXNetError(f"Parameter '{self._name}': shape "
                                 f"{tuple(src.shape)} does not match "
                                 f"{tuple(t.shape)}")
            replace_parameter(self._module, self._attr,
                              src.detach().to(t.dtype).clone(),
                              t.requires_grad)
            return
        if tuple(src.shape) != tuple(t.shape):
            raise MXNetError(f"Parameter '{self._name}': shape "
                             f"{tuple(src.shape)} does not match "
                             f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(src)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Draw the parameter on ``ctx`` (default: the current context)
        from ``mx.random``'s generator of that device; a parameter of
        unknown shape is deferred to its block's first call."""
        t = self.tensor
        if is_initialized(t) and not force_reinit:
            return
        own = getattr(t, "_mx_init", None)
        initializer = init_mod.create(init or own or default_init)
        if not shape_known(t):
            defer(self._module, self._attr, initializer, own is not None,
                  deferred_device(ctx), _random.generator)
            return
        dev = resolve_device(ctx)
        materialize(self._name, self._module, self._attr, initializer,
                    own is not None, dev, _random.generator(dev))

    def cast(self, dtype):
        t = self.tensor
        replace_parameter(self._module, self._attr,
                          t.detach().to(torch_dtype(dtype)), t.requires_grad)

    def reset_ctx(self, ctx):
        """Move an initialized parameter to ``ctx`` (the first of a list);
        its gradient buffer starts again from zero there."""
        t = self.tensor
        if is_initialized(t):
            dev = resolve_device(ctx[0] if isinstance(ctx, (list, tuple))
                                 else ctx)
            replace_parameter(self._module, self._attr,
                              t.detach().to(dev), t.requires_grad)


class Constant(Parameter):
    """A non-trainable parameter holding ``value`` (MXNet's
    ``gluon.Constant``), on the value's device or the current
    context."""

    def __init__(self, name, value=None):
        if value is None:                   # the 2.x form Constant(value)
            name, value = "const", name
        if isinstance(value, NDArray):
            t = value.tensor.detach().clone()
        else:
            t = torch.as_tensor(value)
            if t.is_floating_point():
                t = t.to(torch.float32)
            t = t.to(resolve_device(None))
        super().__init__(name=name, grad_req="null", shape=tuple(t.shape),
                         dtype=t.dtype, init=init_mod.Constant(0.0),
                         differentiable=False)
        replace_parameter(self._module, self._attr, t, False)
        self.value = NDArray(self.tensor, alias=True)


class ParameterDict:
    """Ordered name → :class:`Parameter` mapping.  A block's own
    (``block.params``) creates parameters on the block in :meth:`get`."""

    def __init__(self, prefix="", shared=None, owner=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared
        self._owner = owner

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

    def get(self, name, **kwargs) -> Parameter:
        """The parameter ``name``, created from ``kwargs`` (the
        :class:`Parameter` arguments) if it does not exist yet: on the
        owning block under the attribute ``name``, else standalone under
        ``prefix + name``."""
        if self._owner is not None:
            owner = self._owner
            if name not in owner._parameters:
                owner._new_param(name, kwargs.pop("shape", None) or (),
                                 **kwargs)
            h = Parameter._handle(name, owner, name)
            self._params[name] = h
            return h
        full = self._prefix + name
        if full not in self._params:
            if self._shared is not None and full in self._shared:
                self._params[full] = self._shared[full]
            else:
                self._params[full] = Parameter(name=full, **kwargs)
        return self._params[full]

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

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

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
