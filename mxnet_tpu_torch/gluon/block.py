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

``HybridBlock.export`` serializes the block's plain forward, traced by
``torch.export`` with its parameters as inputs, beside a parameter file
either package reads; :class:`SymbolBlock` runs it again without the
Python model class.  A transformer traced on the card carries its flash
attention as the custom op ``mxnet_tpu_torch::flash_fwd``, so the
reloaded program launches B1 (``ops/flash.py``).
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
from ..utils.graphs import compile_enabled, in_program
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, SeededDraws, defer, deferred_device,
                        finish_deferred, is_initialized, materialize,
                        new_parameter, replace_parameter, set_shape,
                        shape_known)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

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
                   differentiable=True, lr_mult=1.0, wd_mult=1.0,
                   grad_stype="default"):
        """Register a new uninitialized parameter ``attr``; a 0 in
        ``shape`` is inferred at the first call."""
        p = new_parameter(shape, dtype, init=init,
                          allow_deferred_init=allow_deferred_init,
                          grad_req=grad_req if differentiable else "null",
                          grad_stype=grad_stype)
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
        # the last call's input signature, for export
        self._export_args = None

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

    def _clear_cached_op(self):
        self._cached_op = None

    def optimize_for(self, x, *args, backend=None, static_alloc=False,
                     static_shape=False, **kwargs):
        """Rewrite by a registered subgraph backend (``'FUSE_BN'``, or one
        registered with ``mxnet_tpu_torch.subgraph.register_backend``),
        then hybridize and run one forward on ``x``."""
        if backend is not None:
            from .. import subgraph as _subgraph
            result = _subgraph.optimize_for(self, backend, **kwargs)
            if result is not self:
                raise MXNetError(
                    f"backend {backend!r} returned a new block; the "
                    "in-place method API cannot adopt it — call "
                    "mxnet_tpu_torch.subgraph.optimize_for(net, backend) "
                    "and use its return value instead")
        self.hybridize(True, static_alloc=static_alloc,
                       static_shape=static_shape)
        return self(x, *args)

    def __call__(self, *args, **kwargs):
        # inside another program (a ShardedTrainer step, a serving
        # program, an export's trace) the block runs inline, as jax
        # inlines a jitted call into an enclosing trace, and records no
        # input signature
        inline = in_program()
        if not inline and args and isinstance(
                args[0], (torch.Tensor, NDArray, list, tuple)):
            self._export_args = _signature(args)
        if not self._active or inline or not compile_enabled():
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

    # -------------------------------------------------------------- export
    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json`` (the reference's meta keys, format
        ``torch.export``), ``path-symbol.pt2`` (the program) and
        ``path-NNNN.params`` (``MXTPU1``, either package reads it).

        The program is this block's plain forward in inference mode, on
        the last call's input signature (export needs a prior call),
        traced by ``torch.export`` with hybridization bypassed and the
        parameters as its leading inputs in ``param_order``, so the
        params file supplies the weights.  The batch dimension is
        symbolic where the trace allows it (``symbolic_batch``).
        Returns (symbol file, params file)."""
        import json
        if self._export_args is None:
            raise MXNetError(
                "export requires a prior forward call (to fix the input "
                "signature) — run net(x) once first")
        args = _example_args(self._export_args)
        flat, spec, _static = _flatten_in_args(args)
        named = dict(self.named_parameters())
        order = list(named)
        params = [named[n].detach() for n in order]
        fn = _Exported(self, order, spec)
        traced = fn.traced
        try:                 # symbolic batch, so any batch size reloads
            ep = _trace(fn, params, flat, dynamic=True)
            symbolic = True
        except Exception:    # a trace that pins the batch: static shapes
            ep = _trace(fn, params, flat, dynamic=False)
            symbolic = False
        params_file = f"{path}-{epoch:04d}.params"
        self.save_parameters(params_file)
        graph_file = f"{path}-symbol.pt2"
        ep.example_inputs = None      # they hold the weights: not saved
        torch.export.save(ep, graph_file)
        meta = {
            "framework": "mxnet_tpu_torch",
            "format": "torch.export",
            "graph_file": graph_file,
            "params_file": params_file,
            "param_order": order,
            "n_inputs": len(flat),
            "out_tree": traced["out_tree"],
            "symbolic_batch": symbolic,
            "device": str(params[0].device if params else flat[0].device),
        }
        sym_file = f"{path}-symbol.json"
        with open(sym_file, "w") as f:
            json.dump(meta, f)
        return sym_file, params_file


class SymbolBlock(HybridBlock):
    """Runs a program written by :meth:`HybridBlock.export` without the
    Python model class (MXNet's ``gluon.SymbolBlock.imports``).  Its
    parameters are those of the params file, under their structural
    names with ``.`` as ``_``, frozen: the exported program is
    inference only, as the reference's is."""

    def __init__(self, outputs=None, inputs=None, params=None):
        super().__init__()
        if outputs is not None or inputs is not None:
            raise MXNetError("a SymbolBlock over a Symbol is not ported; "
                             "load an exported block with "
                             "SymbolBlock.imports")
        self._program = None
        self._meta = None
        self._param_attrs = []

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """Load ``symbol_file`` (from :meth:`HybridBlock.export`) and its
        params onto ``ctx`` (default: the current context, the card
        unless the caller asks for the CPU).  A program traced on
        another kind of device is refused, as the reference refuses a
        program exported for another platform."""
        import json
        import os

        from ..ops import flash  # noqa: F401  (registers the B1 op)
        from ..utils.serialization import load as _load
        with open(symbol_file) as f:
            meta = json.load(f)
        if meta.get("format") != "torch.export":
            raise MXNetError(
                f"{symbol_file}: format {meta.get('format')!r} from "
                f"framework {meta.get('framework')!r}; this package runs "
                "the 'torch.export' programs its own HybridBlock.export "
                "writes, not the reference's 'stablehlo' ones (the "
                "-NNNN.params files do cross between the packages)")
        dev = resolve_device(ctx)
        here = os.path.dirname(os.path.abspath(symbol_file))

        def local(fname):
            return fname if os.path.exists(fname) else \
                os.path.join(here, os.path.basename(fname))

        if torch.device(meta["device"]).type != dev.type:
            raise MXNetError(
                f"{symbol_file}: exported on {meta['device']}, imported "
                f"on {dev}; a program runs on the device it was traced "
                "on (its attention is B1's op only when traced on the "
                f"card), so export the block on {dev.type}")
        ep = torch.export.load(local(meta["graph_file"]))
        block = SymbolBlock()
        block._meta = meta
        block._program = ep.module()
        loaded = _load(local(param_file or meta["params_file"]))
        for name in meta["param_order"]:
            attr = name.replace(".", "_")
            block.register_parameter(attr, torch.nn.Parameter(
                torch.as_tensor(loaded[name]).to(dev), requires_grad=False))
            block._param_attrs.append(attr)
        block._device = dev
        return block

    def forward(self, *args):
        flat, _spec, _static = _flatten_in_args(args)
        params = [self._parameters[a] for a in self._param_attrs]
        outs = self._program(*params, *flat)
        return _unflatten_out(list(outs), _json_tree(self._meta["out_tree"]))


class _Exported(torch.nn.Module):
    """``block``'s forward as a function of (parameters..., inputs...),
    recording its output tree in the reference's form."""

    def __init__(self, block, order, spec):
        super().__init__()
        # not a submodule: the trace must not lift the block's own
        # tensors as the program's state
        self.__dict__["block"] = block
        self.order, self.spec = order, spec
        # written by the traced forward (export restores copies of the
        # module's attributes after tracing: read it through a reference
        # taken before)
        self.traced = {}

    def forward(self, *flat):
        from .cached_op import _unflatten_in
        n = len(self.order)
        args, kwargs = _unflatten_in(self.spec, list(flat[n:]))
        out = torch.func.functional_call(
            self.block, dict(zip(self.order, flat[:n])), tuple(args), kwargs)
        vals, self.traced["out_tree"] = _flatten_out(out)
        return tuple(vals)


def _trace(fn, params, flat, dynamic):
    """``torch.export`` of ``fn`` over (params, inputs) in inference mode
    with hybridized blocks inline and aux losses off; ``dynamic`` makes
    each input's leading dimension one symbolic batch."""
    from ..utils.graphs import inside
    shapes = None
    if dynamic:
        b = torch.export.Dim("b")
        # one entry: forward takes its inputs as *flat
        shapes = (tuple([None] * len(params) +
                        [{0: b} if x.dim() >= 1 and x.shape[0] > 0 else None
                         for x in flat]),)
        flat = [_widen(x) for x in flat]
    prev_rec = _base.set_recording(False)
    prev_aux = _base.set_aux_collection(False)
    try:
        with torch.no_grad(), _base.training_mode(False), inside():
            return torch.export.export(fn, tuple(params) + tuple(flat),
                                       dynamic_shapes=shapes, strict=False)
    finally:
        _base.set_aux_collection(prev_aux)
        _base.set_recording(prev_rec)


def _widen(x):
    """An example input with a batch of at least 2 (a batch of 1 would
    pin the symbolic dimension)."""
    if x.dim() == 0 or x.shape[0] >= 2:
        return x
    return x.expand(2, *x.shape[1:]).clone()


def _signature(args):
    """(shape, dtype, device) of each array of ``args`` (alone or in a
    list or tuple), other arguments as they are."""
    def one(a):
        if isinstance(a, NDArray):
            a = a._t
        if isinstance(a, torch.Tensor):
            return ("arr", (tuple(a.shape), a.dtype, a.device))
        if isinstance(a, (list, tuple)):
            return ("seq", (type(a), [one(x) for x in a]))
        return ("static", a)
    return [one(a) for a in args]


def _example_args(sig):
    """Zero tensors of a recorded signature."""
    def one(kind, meta):
        if kind == "arr":
            shape, dtype, device = meta
            return torch.zeros(shape, dtype=dtype, device=device)
        if kind == "seq":
            typ, items = meta
            return typ(one(*x) for x in items)
        return meta
    return [one(*x) for x in sig]


def _flatten_in_args(args):
    from .cached_op import _flatten_in
    return _flatten_in(args, {})


def _flatten_out(out):
    """(tensors, tree): the tree in the reference's form, ``("nd",
    None)`` for one array, ``("seq", (name, [(n, subtree), ...]))`` for
    a tuple or list."""
    if isinstance(out, NDArray):
        out = out._t
    if isinstance(out, torch.Tensor):
        return [out], ("nd", None)
    if isinstance(out, (tuple, list)):
        vals, subs = [], []
        for o in out:
            v, t = _flatten_out(o)
            vals.extend(v)
            subs.append((len(v), t))
        return vals, ("seq", ("tuple" if isinstance(out, tuple) else "list",
                              subs))
    raise MXNetError(f"export: output of type {type(out).__name__} is not "
                     "an array or a tuple/list of them")


def _unflatten_out(flat, tree):
    kind, meta = tree
    if kind == "nd":
        return flat[0]
    name, subtrees = meta
    out, i = [], 0
    for n, t in subtrees:
        out.append(_unflatten_out(flat[i:i + n], t))
        i += n
    return tuple(out) if name == "tuple" else out


def _json_tree(t):
    """JSON turns the out_tree tuples into lists; normalize."""
    kind, meta = t
    if kind == "nd":
        return ("nd", None)
    name, subtrees = meta
    return ("seq", (name, [(n, _json_tree(sub)) for n, sub in subtrees]))


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
