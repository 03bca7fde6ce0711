"""Block / HybridBlock on ``torch.nn.Module`` (counterpart of
``mxnet_tpu/gluon/block.py``).

Structural parameter names are the reference's (``gluon/block.py:111``):
a parameter is named by its attribute path, ``h0.attn.q_proj.weight``
(``0.weight`` for the first child of a container), which is exactly
what ``nn.Module.named_parameters`` yields for the same tree.  Those
names key ``save_parameters``/``load_parameters``,
:func:`mxnet_tpu_torch.utils.convert.load_numpy_params` and
:meth:`Block.collect_params` (a ``ParameterDict`` of handles; the tensor
view is torch's own ``named_parameters()``), so one parameter file
serves both packages.  ``prefix``/``name`` keep the reference's
per-class counters (``dense0_``) for display only.

A Block has two calling conventions.  Tensors in, tensors out: torch's
own semantics, which ``ShardedTrainer``, ``InferenceEngine`` and the
models use.  NDArrays in, NDArrays out: MXNet's, where the call builds a
graph only inside ``autograd.record()``.  A :class:`HybridBlock` that
defines ``hybrid_forward(self, F, x, ...)`` runs it with ``F = mx.nd``
and its parameters as NDArrays, under either convention.  A block whose
parameters were deferred (a 0 in a declared shape) infers their shapes
from its first call's inputs (:meth:`Block.infer_shape`, given tensors)
and draws them before its forward runs, as the reference's ``__call__``
retry does.  Forward hooks and pre-hooks are torch's; they see tensors.

``hybridize`` compiles, as the reference's does: a hybridized block's
call goes through its :class:`~.cached_op.CachedOp`, one CUDA graph per
signature on the card (its forward, and under ``autograd.record()`` a
forward and a backward graph replayed as one autograd node), the same
function on the same static buffers on the CPU.  The children run
inside the parent's graphs, and a hybridized block called inside
another program (a ``ShardedTrainer`` step, a serving program) runs
inline in it.  ``static_alloc`` and ``static_shape`` are
recorded hints, as in the reference, which compiles whatever they say.
A block whose parameters wait for their first input settles them with
one imperative call and calls its CachedOp again (the reference's
deferred-initialization retry).
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, Optional

import torch

from .. import base as _base
from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..utils.graphs import in_program
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, SeededDraws, defer, deferred_device,
                        finish_deferred, is_initialized, materialize,
                        new_parameter, replace_parameter, set_shape,
                        shape_known)

__all__ = ["Block", "HybridBlock"]

_block_counters: Dict[str, int] = {}


def _gen_prefix(cls_name: str) -> str:
    n = _block_counters.get(cls_name, 0)
    _block_counters[cls_name] = n + 1
    return f"{cls_name.lower()}{n}_"


class Block(torch.nn.Module):
    """Base class for all layers and models."""

    def __init__(self, prefix: Optional[str] = None, params=None):
        super().__init__()
        if params is not None:
            raise MXNetError("sharing parameters through params= is not "
                             "ported: assign the same Parameter to both "
                             "blocks' attributes")
        self._prefix = prefix if prefix is not None else \
            _gen_prefix(type(self).__name__)
        # device chosen at construction (get_gpt2(device=...)); None
        # means "resolve at initialize time"
        self._device: Optional[torch.device] = None
        # whether a parameter of this block waits for its first input
        self._deferred_pending = False

    # ----------------------------------------------------------- registry
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._adopt(name, value)
            return
        super().__setattr__(name, value)

    def _adopt(self, name, handle):
        """Register the parameter behind ``handle`` as attribute ``name``
        (a standalone parameter's tensor moves in) and point the handle
        here."""
        if handle._module is self and handle._attr == name:
            return
        t = handle.tensor
        self.register_parameter(name, t)
        if getattr(t, "_mx_deferred", None) is not None:
            self._deferred_pending = True
        handle._module, handle._attr = self, name

    def _new_param(self, attr: str, shape, dtype="float32", init=None,
                   allow_deferred_init=False, grad_req="write",
                   differentiable=True, lr_mult=1.0, wd_mult=1.0):
        """Register a new uninitialized parameter ``attr``; a 0 in
        ``shape`` is inferred at the first call."""
        p = new_parameter(shape, dtype, init=init,
                          allow_deferred_init=allow_deferred_init,
                          grad_req=grad_req if differentiable else "null")
        if lr_mult != 1.0:
            p._mx_lr_mult = lr_mult
        if wd_mult != 1.0:
            p._mx_wd_mult = wd_mult
        self.register_parameter(attr, p)
        return p

    def register_child(self, block: "Block", name: Optional[str] = None):
        """Add ``block`` as a child named ``name`` (default: the next
        index, ``"0"``, ``"1"``, ...)."""
        self.add_module(name if name is not None else
                        str(len(self._modules)), block)
        return block

    # ------------------------------------------------------------- naming
    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._prefix.rstrip("_")

    def name_scope(self):
        """``with block.name_scope():`` keeps the idiom; children take
        their structural names from their attributes."""
        return contextlib.nullcontext(self)

    @property
    def params(self) -> ParameterDict:
        """This block's own parameters (not its children's), by
        attribute; ``params.get(name, shape=...)`` creates one."""
        out = ParameterDict(self._prefix, owner=self)
        out.update({attr: Parameter._handle(attr, self, attr)
                    for attr, p in self._parameters.items()
                    if p is not None})
        return out

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
        out = ParameterDict(self._prefix)
        out.update({name: Parameter._handle(name, m, attr)
                    for name, m, attr in self._param_slots()
                    if rx is None or rx.match(name)})
        return out

    def _collect_params_with_prefix(self, prefix="") -> Dict[str, Parameter]:
        """Structural name → handle (the reference's save/load view)."""
        return {prefix + k: p for k, p in self.collect_params().items()}

    # ------------------------------------------------------------ forward
    def __call__(self, *args, **kwargs):
        if self._deferred_pending:
            self._finish_deferred(_unwrap(args), _unwrap(kwargs))
        if not any(isinstance(a, NDArray) for a in (*args,
                                                    *kwargs.values())):
            return super().__call__(*args, **kwargs)
        with torch.set_grad_enabled(_base.is_recording()):
            out = super().__call__(*_unwrap(args), **_unwrap(kwargs))
        return _wrap(out)

    def _finish_deferred(self, args, kwargs):
        """Infer this block's unknown parameter shapes from the first
        call's (tensor) inputs and draw them, on the device recorded at
        ``initialize`` or else the inputs'."""
        own = [(attr, p) for attr, p in self._parameters.items()
               if p is not None]
        if any(not shape_known(p) for _a, p in own):
            self.infer_shape(*args, **kwargs)
        dev = next((a.device for a in (*args, *kwargs.values())
                    if isinstance(a, torch.Tensor)), None)
        for attr, _p in own:
            finish_deferred(attr, self, attr, dev)
        self._deferred_pending = False

    def infer_shape(self, *args, **kwargs):
        """Set the unknown parameter shapes from the inputs (tensors);
        layers with deferred parameters override this."""
        raise MXNetError(
            f"{type(self).__name__} has uninitialized parameters with "
            "unknown shape and no infer_shape — initialize with explicit "
            "shapes or run a forward pass layer by layer")

    def _set_shape(self, attr, shape):
        set_shape(self, attr, shape)

    def hybridize(self, active=True, **kwargs):
        """Pass ``hybridize`` on to the children (a plain Block is never
        compiled itself)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    # --------------------------------------------------------------- init
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

    def initialize(self, init=None, device=None, seed: int = 0,
                   force_reinit: bool = False, ctx=None, verbose=False):
        """Give every uninitialized parameter values on ``device`` (or
        MXNet's ``ctx``; default: the construction device, else the
        current context), drawn by the initializer attached to it, else
        ``init`` (default ``Uniform(0.07)``), from a ``torch.Generator``
        seeded with ``seed``, in structural-name order.  A block with a
        parameter of unknown shape has all of its parameters deferred to
        its first call: they materialize together on the device given
        here, else the construction device or the enclosing ``with
        ctx:`` scope's, else the input's, and draw from the same seeded
        generator in the order they materialize."""
        given = device if device is not None else ctx
        default = init_mod.create(init)
        draws = SeededDraws(seed)
        dev = None
        slots = list(self._param_slots())
        # a block with a parameter of unknown shape defers all of its
        # parameters, so they materialize together on one device
        waiting = {id(m) for _n, m, attr in slots
                   if not shape_known(m._parameters[attr])}
        for name, m, attr in slots:
            p = m._parameters[attr]
            if is_initialized(p) and not force_reinit:
                continue
            own = getattr(p, "_mx_init", None)
            chosen, explicit = (own, True) if own is not None else \
                (default, False)
            if id(m) in waiting:
                defer(m, attr, chosen, explicit,
                      deferred_device(given, self._device), draws)
                continue
            if dev is None:
                dev = self._target_device(given)
            materialize(name, m, attr, chosen, explicit, dev, draws(dev))
        if dev is not None:
            self._device = dev
        return self

    def cast(self, dtype):
        """Cast every parameter (initialized or not) to ``dtype``; caches
        the serving surface builds follow it."""
        dt = torch_dtype(dtype)
        with torch.no_grad():
            for _name, m, attr in self._param_slots():
                p = m._parameters[attr]
                replace_parameter(m, attr, p.detach().to(dt),
                                  p.requires_grad)
        return self

    # ---------------------------------------------------------- save/load
    def save_parameters(self, filename: str, deduplicate=False):
        """Write every parameter under its structural name into an
        ``MXTPU1`` container."""
        from ..utils.serialization import save
        params = dict(self.named_parameters(remove_duplicate=False))
        for k, p in params.items():
            if not is_initialized(p):
                raise MXNetError(f"Parameter '{k}' has not been "
                                 "initialized")
        save(filename, params)

    def load_parameters(self, filename: str, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current", device=None):
        """Load an ``MXTPU1`` container written by either package.  A
        parameter the file lacks raises unless ``allow_missing``; a name
        the model lacks raises unless ``ignore_extra``.  Values take the
        parameter's dtype, as the reference's ``set_data`` gives them
        (``cast_dtype``/``dtype_source`` are accepted for its
        signature)."""
        from ..utils.convert import load_numpy_params
        from ..utils.serialization import load
        return load_numpy_params(
            self, load(filename), device=device if device is not None
            else ctx, allow_missing=allow_missing, ignore_extra=ignore_extra)

    save_params = save_parameters
    load_params = load_parameters

    # ------------------------------------------------------------ display
    def summary(self, *inputs):
        """Print each block with its parameter count, and the total."""
        lines = [f"{'Layer':<40}{'Output':<24}{'Params':<12}"]
        total = 0

        def walk(b, depth):
            nonlocal total
            n = sum(p.numel() for p in b._parameters.values()
                    if p is not None and is_initialized(p))
            total += n
            lines.append(f"{'  ' * depth + type(b).__name__:<40}"
                         f"{'':<24}{n:<12}")
            for c in b.children():
                walk(c, depth + 1)

        walk(self, 0)
        lines.append(f"Total params: {total}")
        print("\n".join(lines))

    def __repr__(self):
        s = f"{type(self).__name__}(\n"
        for name, child in self._modules.items():
            child_repr = repr(child).replace("\n", "\n  ")
            s += f"  ({name}): {child_repr}\n"
        return s + ")"


class HybridBlock(Block):
    """A Block that ``hybridize`` compiles: its calls then replay one
    CUDA graph per signature (:class:`~.cached_op.CachedOp`).  A
    subclass defines ``forward`` over tensors, or
    ``hybrid_forward(self, F, x, *args, **params)`` over NDArrays."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._cached_op = None
        # False runs the CachedOp's functions without graphs on the card
        self._graphs = True

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None, **kwargs):
        """Compile this block (``active``), dropping any program compiled
        before; the flags are recorded.  The children run inside this
        block's programs, as in the reference."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._cached_op = None
        super().hybridize(active=False)

    def __call__(self, *args, **kwargs):
        # inside another program (a ShardedTrainer step, a serving
        # program) the block runs inline, as jax inlines a jitted call
        # into an enclosing trace
        if not self._active or in_program():
            return super().__call__(*args, **kwargs)
        for _ in range(2):
            try:
                return self._call_cached_op(*args, **kwargs)
            except DeferredInitializationError:
                self._settle_deferred(*args, **kwargs)
        return self._call_cached_op(*args, **kwargs)

    def _settle_deferred(self, *args, **kwargs):
        """One imperative call settles every deferred shape (each layer
        infers from its own input), as the reference's first dynamic
        run does."""
        Block.__call__(self, *args, **kwargs)

    def _call_cached_op(self, *args, **kwargs):
        from .cached_op import CachedOp
        if self._cached_op is None:
            self._cached_op = CachedOp(self, self._flags)
        return self._cached_op(*args, **kwargs)

    def forward(self, *args, **kwargs):
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError(f"{type(self).__name__} must "
                                      "implement forward or hybrid_forward")
        from .. import ndarray as nd
        params = {attr: NDArray(p, alias=True)
                  for attr, p in self._parameters.items() if p is not None}
        return _run_nd(lambda *a, **k: self.hybrid_forward(nd, *a, **k,
                                                           **params),
                       args, kwargs)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _run_nd(fn, args, kwargs):
    """``fn`` over the arguments as NDArrays, its result as tensors.
    Tensors arrive here under the caller's grad mode, which the NDArray
    ops inside keep by reading it as the recording flag."""
    prev = _base.set_recording(torch.is_grad_enabled())
    try:
        out = fn(*_wrap(args), **_wrap(kwargs))
    finally:
        _base.set_recording(prev)
    return _unwrap(out)


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
