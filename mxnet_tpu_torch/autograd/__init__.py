"""Autograd: record/pause scopes, backward, grad and custom Functions
(counterpart of ``mxnet_tpu/autograd/__init__.py``), built on torch's
autograd with no tape of its own.

``record()`` turns recording on: NDArray ops and NDArray calls into a
Block then build torch's graph.  :func:`backward` finds the graph's
leaves, zeroes the gradient buffer of each leaf whose ``grad_req`` is
``'write'`` (MXNet's default; torch itself always adds) and leaves
``'add'`` buffers as they are, then lets torch accumulate into them in
place, so every handle on a buffer sees the new gradient.
"""
from __future__ import annotations

import torch

from .. import base as _base
from ..ndarray.ndarray import NDArray

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

is_recording = _base.is_recording
is_training = _base.is_training
set_recording = _base.set_recording
set_training = _base.set_training


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._enter_record = is_record
        self._enter_train = train_mode_
        self._prev_record = self._prev_train = None

    def __enter__(self):
        if self._enter_record is not None:
            self._prev_record = _base.set_recording(self._enter_record)
        if self._enter_train is not None:
            self._prev_train = _base.set_training(self._enter_train)
        return self

    def __exit__(self, *exc):
        if self._enter_record is not None:
            _base.set_recording(self._prev_record)
        if self._enter_train is not None:
            _base.set_training(self._prev_train)
        return False


def record(train_mode: bool = True):
    """``with autograd.record():`` — build the graph (and train mode)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable a leaf whose gradient buffer is the matching
    array of ``gradients``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        t = v._t if v._t.is_leaf else v._t.detach()
        t.requires_grad_(req != "null")
        t.grad = g._t
        t._mx_grad_req = req
        v._t = t


def _graph_leaves(heads):
    """The leaf tensors (those that require a gradient) that ``heads``'
    graph reaches, each once."""
    leaves, seen, stack = [], set(), []
    for t in heads:
        if t.grad_fn is None:
            leaves.append(t)
        else:
            stack.append(t.grad_fn)
    nodes = []           # holds every node visited, so ids stay unique
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        nodes.append(fn)
        var = getattr(fn, "variable", None)     # AccumulateGrad
        if var is not None:
            leaves.append(var)
            continue
        stack.extend(n for n, _ in fn.next_functions if n is not None)
    return leaves


def _head_tensors(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    ts = [h._t for h in heads]
    for t in ts:
        if not t.requires_grad:
            raise _base.MXNetError(
                "cannot differentiate a head that was not computed inside "
                "autograd.record() from an array with attach_grad() or a "
                "parameter")
    if head_grads is None:
        gs = [torch.ones_like(t) for t in ts]
    else:
        gs = [torch.ones_like(t) if g is None else
              (g._t if isinstance(g, NDArray) else torch.as_tensor(
                  g, dtype=t.dtype, device=t.device))
              for t, g in zip(ts, head_grads)]
    return ts, gs


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (head gradients default to ones) into every
    reached leaf's buffer: written for ``grad_req='write'``, added for
    ``'add'``.  A leaf with no buffer gets one."""
    ts, gs = _head_tensors(heads, head_grads)
    with torch.no_grad():
        for leaf in _graph_leaves(ts):
            if getattr(leaf, "_mx_grad_req", "write") == "write" and \
                    leaf.grad is not None:
                leaf.grad.zero_()
    torch.autograd.backward(ts, gs, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` as new
    arrays (zeros where a variable does not reach a head), without
    touching any ``.grad`` buffer."""
    ts, gs = _head_tensors(heads, head_grads)
    if not isinstance(variables, (list, tuple)):
        variables = [variables]
    vs = [v._t for v in variables]
    out = torch.autograd.grad(ts, vs, gs, retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v) if g is None else g)
            for v, g in zip(vs, out)]


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function`'s NDArray forward and backward as one
    torch autograd node."""

    @staticmethod
    def forward(ctx, fn, *ts):
        with pause():
            outs = fn.forward(*[NDArray(t) for t in ts])
        ctx.fn = fn
        fn._single = not isinstance(outs, (list, tuple))
        outs = [outs] if fn._single else list(outs)
        return tuple(o._t for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        with pause():
            grads = ctx.fn.backward(*[NDArray(g) for g in gs])
        if not isinstance(grads, (list, tuple)):
            grads = [grads]
        return (None,) + tuple(None if g is None else g._t for g in grads)


class Function:
    """Custom differentiable function: subclass and implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` with
    NDArray ops; ``save_for_backward`` keeps what backward needs."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        with torch.set_grad_enabled(_base.is_recording()):
            outs = _Bridge.apply(self, *[x._t for x in inputs])
        res = [NDArray(o) for o in outs]
        return res[0] if self._single else res
