"""CachedOp: a hybridized block's compiled form, one CUDA graph per
signature (counterpart of ``mxnet_tpu/gluon/cached_op.py``).

The reference traces a hybridized block once per signature into one
jitted XLA computation, and under ``autograd.record()`` registers it as
one tape node whose backward is one more compiled computation
(``jax.vjp``).  The port keeps its cache and its key, and compiles into
CUDA graphs (``utils/graphs.py``):

- The key is the reference's: the training flag, the static
  (non-array) arguments, and the parameters' and array inputs' shapes
  and dtypes (``_flatten_in``).  ``_jit_cache`` holds one entry per key,
  as the reference's does.
- An entry holds a forward program, and once the block is called under
  recording, a training program: a forward graph and a backward graph
  (``torch.autograd.grad`` of the outputs with respect to the inputs
  that take a gradient and every parameter, into static gradient
  buffers), replayed through one ``torch.autograd.Function`` node, as
  the reference registers one ``OpNode``.
- A program's first call warms it up on its capture stream, with the
  aux state (BatchNorm's moving statistics) and the device generator put
  back afterwards, captures it and replays it; later calls replay.  A
  capture that fails raises ``MXNetError`` naming the block and the
  key: there is no eager retry.
- BatchNorm's moving statistics are written in place by the captured
  forward (the reference writes its functionalized updates back after
  the call); both leave the same statistics.
- The MoE routers' aux losses leave as extra outputs and are recorded
  into the caller's collector, as the reference re-records them.
- The device generator and the twin states of remat layers are
  registered with the training graphs (``random.GraphDraws``), so each
  replay draws fresh dropout masks and a remat layer's recomputation
  draws its forward's.

On the CPU, and on the card where the block's private ``_graphs`` is
False, the same functions run on the same static buffers at every call.
On the card a program's outputs and gradients live in its graph's pool,
and a call returns copies of them, so a result outlives the next call
as an eager call's does.  A recorded program holds the activations of
one call until its backward: a recorded call of the same key made
while an earlier one's backward is still to run gets a program of its
own (the GAN step that calls its discriminator twice under one
``record()``).  The children, and a hybridized block met inside
another program (a ``ShardedTrainer`` step, a serving program), run
inline (``utils/graphs.py`` :func:`in_program`).  Inputs arrive as
NDArrays or as tensors, under either calling convention of
``gluon/block.py``, and the outputs follow the inputs'.

``make_pure_fn``, ``param_snapshot`` and ``collect_block_params`` of the
reference serve its serving engine, which traces pure functions of the
parameters; the port's engine has programs of its own
(``serving/graphs.py``), so they are not ported.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import torch

from .. import base as _base
from .. import random as _random
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..utils.graphs import Program
from .parameter import DeferredInitializationError, is_initialized

__all__ = ["CachedOp"]


class CachedOp:
    """The compiled form of ``block`` (a HybridBlock), with the
    ``hybridize`` flags it was given (hints: every key compiles)."""

    def __init__(self, block, flags=None):
        self.block = block
        self.flags = flags or {}
        self._jit_cache: Dict = {}
        self._stream = None

    # ------------------------------------------------------------------
    def _params(self) -> List[torch.Tensor]:
        """The block's parameters, each once, checked initialized
        (``DeferredInitializationError`` for the caller's retry)."""
        params = list(self.block.parameters())
        for name, p in self.block.named_parameters():
            if not is_initialized(p):
                if getattr(p, "_mx_deferred", None) is not None:
                    raise DeferredInitializationError(
                        f"Parameter '{name}' pending deferred init — call "
                        "the block with data first")
                raise MXNetError(f"Parameter '{name}' has not been "
                                 "initialized. Call .initialize() first")
        return params

    def __call__(self, *args, **kwargs):
        params = self._params()
        nd_in = _has_ndarray(args) or _has_ndarray(tuple(kwargs.values()))
        flat, spec, static_sig = _flatten_in(args, kwargs)
        train = _base.is_training()
        sig = (train, static_sig,
               tuple((tuple(p.shape), str(p.dtype)) for p in params),
               tuple((tuple(x.shape), str(x.dtype)) for x in flat))
        entry = self._jit_cache.get(sig)
        if entry is None or any(a is not b for a, b in
                                zip(entry.params, params)):
            entry = self._jit_cache[sig] = _Entry(self, sig, spec, train,
                                                  params, flat)
        recording = _base.is_recording() if nd_in else \
            torch.is_grad_enabled()
        needs_grad = recording and (
            any(p.requires_grad for p in params)
            or any(x.requires_grad for x in flat))
        if needs_grad:
            outs, aux = entry.train_call(flat)
        else:
            outs, aux = entry.infer_call(flat)
        if recording or _base.aux_collection_active():
            for a in aux:          # the collector holds tensors
                _base.record_aux_loss(a)
        out = _unflatten_out(list(outs), entry.out_tree)
        return _wrap(out) if nd_in else out

    # -------------------------------------------------------- capture
    def _graph_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _name(self, sig) -> str:
        """The block and a signature, briefly: the parameters by count."""
        train, static, params, inputs = sig
        return (f"CachedOp({type(self.block).__name__}) signature (train="
                f"{train}, static={static}, inputs={inputs}, "
                f"{len(params)} parameters)")

    def _failed(self, sig, what, e):
        return MXNetError(f"{self._name(sig)}: capturing the {what} "
                          f"failed: {type(e).__name__}: {e}")


class _Entry:
    """One key's programs: the forward, and the recorded forms."""

    def __init__(self, op: CachedOp, sig, spec, train, params, flat):
        self.op, self.sig, self.spec, self.train = op, sig, spec, train
        self.params = params
        self.device = flat[0].device if flat else params[0].device
        self.graphed = op.block._graphs and self.device.type == "cuda"
        self.out_tree = None
        self.n_aux = 0
        self._infer = None
        # by gradient mask: one program per recorded call whose backward
        # has not run yet, each with its own inputs and activations
        self._train: Dict[tuple, List["_TrainProgram"]] = {}

    def program(self, flat, what) -> Program:
        """A program over static inputs shaped like ``flat``."""
        op = self.op
        return Program(
            flat, self.device, self.graphed,
            lambda e: op._failed(self.sig, what, e),
            stream=op._graph_stream(self.device) if self.graphed else None,
            draws=_random.GraphDraws(self.device))

    def run(self, flat):
        """The block's forward over ``flat`` (tensors): its flat outputs
        followed by the aux losses it recorded; the caller's collector
        entries are set aside and put back."""
        block = self.op.block
        args, kwargs = _unflatten_in(self.spec, flat)
        outer = _base.pop_aux_losses()
        prev = _base.set_aux_collection(True)
        try:
            with _base.training_mode(self.train):
                out = torch.nn.Module.__call__(block, *args, **kwargs)
            aux = _base.pop_aux_losses()
        finally:
            _base.set_aux_collection(prev)
            _base.pop_aux_losses()
            for a in outer:
                _base.record_aux_loss(a)
        outs, self.out_tree = _flatten_out(out)
        self.n_aux = len(aux)
        return tuple(outs) + tuple(_unwrap(a) for a in aux)

    def split(self, outs):
        n = len(outs) - self.n_aux
        return outs[:n], outs[n:]

    def aux_state(self):
        """The block's aux state (parameters that take no gradient, and
        buffers), which a warm-up must leave as it found it."""
        block = self.op.block
        return [p for p in block.parameters() if not p.requires_grad] + \
            list(block.buffers())

    # ------------------------------------------------------- inference
    def infer_call(self, flat):
        prog = self._infer
        if prog is None:
            prog = self._infer = _InferProgram(self, flat)
        return self.split(prog(flat))

    # -------------------------------------------------------- training
    def train_call(self, flat):
        mask = tuple(bool(x.requires_grad) for x in (*flat, *self.params))
        progs = self._train.setdefault(mask, [])
        prog = next((p for p in progs if not p.busy()), None)
        if prog is None:
            prog = _TrainProgram(self, flat, mask)
            progs.append(prog)
        if prog.prog.graphed and not prog.prog.built:
            # before the node exists: its parameters' gradient
            # accumulators would sit on the current stream, which the
            # captured backward must not wait on
            prog.build(flat)
        outs = _Replay.apply(prog, *flat, *self.params)
        return self.split(outs)


def _warm(entry, fn):
    """``fn()`` once, with the aux state and the device generator put
    back afterwards: a warm-up moves no statistic and draws nothing the
    run would not."""
    aux = entry.aux_state()
    saved = [a.detach().clone() for a in aux]
    gen = _random.generator(entry.device)
    rng = gen.get_state()
    try:
        return fn()
    finally:
        with torch.no_grad():
            for a, s in zip(aux, saved):
                a.copy_(s)
        gen.set_state(rng)


class _InferProgram:
    """The forward of one key without a graph of autograd."""

    def __init__(self, entry: _Entry, flat):
        self.entry = entry
        self.prog = entry.program(flat, "forward")
        self.outputs = None

    def _fn(self):
        with torch.no_grad():
            return self.entry.run(self.prog.inputs)

    def __call__(self, flat):
        prog = self.prog
        prog.copy_in(flat)
        if not prog.graphed:
            return prog.run(self._fn)
        if not prog.built:
            self.outputs, = prog.build(lambda: _warm(self.entry, self._fn),
                                       self._fn)
        prog.replay()
        # the next replay rewrites the static outputs: the caller's are
        # copies, as eager calls return new tensors
        return tuple(o.clone() for o in self.outputs)


class _TrainProgram:
    """One recorded call of one key at a time: the forward with its
    autograd graph, and the backward into static gradient buffers, for
    the inputs and parameters that take a gradient (``mask``, over the
    inputs then the parameters)."""

    def __init__(self, entry: _Entry, flat, mask):
        self.entry, self.mask = entry, mask
        self.n_in = len(flat)
        self.prog = entry.program(flat, "recorded forward and backward")
        for buf, need in zip(self.prog.inputs, mask):
            buf.requires_grad_(need)
        self.wrt = [x for x, need in zip(
            (*self.prog.inputs, *entry.params), mask) if need]
        self._pending = None       # the autograd node of the last call
        self.outputs = self.grad_outputs = self.grads = None

    def busy(self) -> bool:
        """Whether a recorded call's backward has yet to run (its node
        is alive): its activations are still needed."""
        return self._pending is not None and self._pending() is not None

    def _forward(self):
        with torch.enable_grad():
            return self.entry.run(self.prog.inputs)

    def _backward(self, outs, gouts):
        diff = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        if not diff:
            return [None] * len(self.wrt)
        return torch.autograd.grad([o for o, _ in diff], self.wrt,
                                   [g for _, g in diff], allow_unused=True)

    def _backward_stage(self, outs):
        gouts = [torch.empty_like(o) for o in outs]
        return gouts, self._backward(outs, gouts)

    def build(self, flat):
        def warm():
            outs = self._forward()
            self._backward(outs, [torch.ones_like(o) for o in outs])
        self.prog.copy_in(flat)
        self.outputs, (self.grad_outputs, self.grads) = self.prog.build(
            lambda: _warm(self.entry, warm), self._forward,
            self._backward_stage)

    def forward(self, ctx, flat):
        """Run the forward; returns the outputs (detached)."""
        prog = self.prog
        prog.copy_in(flat)
        if not prog.graphed:
            outs = ctx.inner = prog.run(self._forward)
        else:
            ctx.offsets = prog.draws.offsets()
            prog.replay(0)
            outs = [o.clone() for o in self.outputs]
        self._pending = weakref.ref(ctx)
        return tuple(o.detach() for o in outs)

    def backward(self, ctx, gouts):
        """The gradients of the inputs (``None`` where ``mask`` is
        False) and the parameters."""
        self._pending = None
        prog = self.prog
        if not prog.graphed:
            grads = prog.run(self._backward, ctx.inner, gouts)
            ctx.inner = None
        else:
            with torch.no_grad():
                for buf, g in zip(self.grad_outputs, gouts):
                    buf.copy_(g)
            prog.replay(1, ctx.offsets)
            grads = [None if g is None else g.clone() for g in self.grads]
        it = iter(grads)
        return [next(it) if need else None for need in self.mask]


class _Replay(torch.autograd.Function):
    """One recorded call of a :class:`_TrainProgram` as one node."""

    @staticmethod
    def forward(ctx, prog, *flat_and_params):
        ctx.prog = prog
        outs = prog.forward(ctx, flat_and_params[:prog.n_in])
        ctx.mark_non_differentiable(*[
            o for o in outs if not (o.is_floating_point()
                                    or o.is_complex())])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        return (None, *ctx.prog.backward(ctx, gouts))


# ---------------------------------------------------------------- flattening

def _is_array(x) -> bool:
    return isinstance(x, (NDArray, torch.Tensor))


def _has_ndarray(xs) -> bool:
    return any(isinstance(x, NDArray) or (
        isinstance(x, (list, tuple)) and any(isinstance(y, NDArray)
                                             for y in x)) for x in xs)


def _unwrap(x):
    return x._t if isinstance(x, NDArray) else x


def _flatten_in(args, kwargs):
    """Flatten the arrays of ``args`` and ``kwargs`` (alone, or in a list
    or tuple of arrays) into tensors; any other argument is static: it
    is passed as it is and keys the cache (the reference's
    ``_flatten_in``, ``cached_op.py:287-320``)."""
    flat: List[torch.Tensor] = []
    spec, static = [], []

    def one(a):
        if _is_array(a):
            flat.append(_unwrap(a))
            return ("arr", None)
        if isinstance(a, (list, tuple)) and a and all(_is_array(x)
                                                      for x in a):
            flat.extend(_unwrap(x) for x in a)
            return ("seq", (type(a), len(a)))
        try:
            hash(a)
            static.append(a)
        except TypeError:
            static.append(repr(a))
        return ("static", a)

    spec = ([one(a) for a in args],
            [(k, one(v)) for k, v in sorted(kwargs.items())])
    return flat, spec, tuple(static)


def _unflatten_in(spec, flat):
    it = iter(flat)

    def one(kind, meta):
        if kind == "arr":
            return next(it)
        if kind == "seq":
            typ, n = meta
            seq = [next(it) for _ in range(n)]
            return list(seq) if typ is list else tuple(seq)
        return meta

    arg_spec, kw_spec = spec
    args = [one(*s) for s in arg_spec]
    return args, {k: one(*s) for k, s in kw_spec}


def _flatten_out(out):
    if _is_array(out):
        return [_unwrap(out)], ("arr", None)
    if isinstance(out, (list, tuple)):
        flats, trees = [], []
        for o in out:
            f, t = _flatten_out(o)
            flats.extend(f)
            trees.append((len(f), t))
        return flats, ("seq", (type(out).__name__, trees))
    raise MXNetError(f"unsupported hybrid_forward output {type(out)}")


def _unflatten_out(flat, tree):
    kind, meta = tree
    if kind == "arr":
        return flat[0]
    name, subtrees = meta
    out, i = [], 0
    for n, t in subtrees:
        out.append(_unflatten_out(flat[i:i + n], t))
        i += n
    return tuple(out) if name == "tuple" else out


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap(v) for v in x)
    return x
