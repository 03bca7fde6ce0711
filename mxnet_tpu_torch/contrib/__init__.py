"""``mx.contrib``: the control-flow operators ``foreach``, ``while_loop``
and ``cond`` (counterpart of ``mxnet_tpu/contrib/__init__.py``), also
reached as ``mx.nd.contrib.<name>``.

Arrays in, arrays out, of the kind given: NDArrays (a
``hybrid_forward``'s ``F = mx.nd``) or tensors (a ``forward`` over
tensors); the functions passed in see items of that kind.

Eagerly, as the reference's eager mode: a Python loop that autograd
records, the predicate read on the host.  Inside a program
(:func:`~mxnet_tpu_torch.utils.graphs.in_program`: a hybridized block's
CachedOp, a ``ShardedTrainer`` step), where the reference lowers to
``lax.scan`` / ``lax.while_loop`` / ``lax.cond``, nothing reads the
host, so one CUDA graph serves every input of its signature:

- ``foreach`` loops over axis 0, whose length is static;
- ``while_loop`` runs ``max_iterations`` trips under an active flag on
  the device: a trip after the loop has ended keeps the old values and
  outputs zeros (``torch.where``), as the reference's ``scan_body`` pads;
- ``cond`` computes both branches and selects.

A branch or trip that is not taken may be non-finite: ``torch.where``
keeps its values out of the result, and its gradient is stopped where
it reads the arrays it did not make (:class:`_GateReads`) — the
gradient of ``torch.where`` alone would carry 0 · inf = NaN back through
a non-finite derivative of the branch not taken, where the reference's
``lax.cond`` differentiates the taken branch only.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from .. import base as _base
from ..ndarray import ops as _ops
from ..ndarray.ndarray import NDArray
from ..utils.graphs import in_program

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _t(x):
    return x._t if isinstance(x, NDArray) else x


def _array_op(name, fn, like, *xs):
    """``fn`` over the tensors of ``xs``, as the kind of ``like``: an nd
    op (recorded under ``autograd.record()``) for an NDArray."""
    if isinstance(like, NDArray):
        return _ops.invoke(name, fn, [x if isinstance(x, NDArray)
                                      else NDArray(x) for x in xs])
    return fn(*[_t(x) for x in xs])


def _stack(items):
    return _array_op("stack", lambda *ts: torch.stack(ts, dim=0), items[0],
                     *items)


def _select(take, a, b):
    """``a`` where the device flag ``take`` holds, else ``b``."""
    return _array_op("where", lambda p, x, y: torch.where(p, x, y), a,
                     take, a, b)


def _flag(pred, like) -> torch.Tensor:
    """``pred`` (an array of one element, or a Python truth value) as a
    0-d bool tensor on ``like``'s device, read on the device."""
    p = _t(pred)
    if isinstance(p, torch.Tensor):
        return p.reshape(()).bool()
    return torch.tensor(bool(p), device=_t(like).device)


def _host_truth(pred) -> bool:
    p = _t(pred)
    return bool(p.reshape(()).item()) if isinstance(p, torch.Tensor) \
        else bool(p)


class _Gate(torch.autograd.Function):
    """Identity forward; backward lets the gradient through where
    ``active`` holds and gives zeros elsewhere (a select, NaN-free)."""

    @staticmethod
    def forward(ctx, active, x):
        ctx.save_for_backward(active)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (active,) = ctx.saved_tensors
        return None, torch.where(active, g, torch.zeros_like(g))


class _GateReads(TorchFunctionMode):
    """While active, every tensor that requires a gradient and that the
    code under the mode did not make reaches a torch function through a
    :class:`_Gate` on ``active`` (one gate per tensor): a branch not
    taken then passes zeros, not 0 · inf, back to what it read."""

    def __init__(self, active: torch.Tensor):
        super().__init__()
        self.active = active
        self.gated = {}         # id(outer tensor) -> (tensor, its gate)
        self.made = set()       # ids of the tensors made under the mode
        self.keep = []          # keeps those ids from being reused

    def _gate(self, x):
        if not isinstance(x, torch.Tensor) or not x.requires_grad \
                or id(x) in self.made:
            return x
        hit = self.gated.get(id(x))
        if hit is None:
            hit = self.gated[id(x)] = (x, _Gate.apply(self.active, x))
            self._mark(hit[1])
        return hit[1]

    def _mark(self, x):
        if isinstance(x, torch.Tensor):
            self.made.add(id(x))
            self.keep.append(x)
        return x

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args = tree_map(self._gate, args)
        kwargs = tree_map(self._gate, kwargs or {})
        out = func(*args, **kwargs)
        tree_map(self._mark, out)
        return out


def _gated(fn: Callable, active: torch.Tensor):
    """``fn()`` with its reads gated on ``active`` where a gradient may
    flow (recording, or torch's grad mode on)."""
    if not (torch.is_grad_enabled() or _base.is_recording()):
        return fn()
    with _GateReads(active):
        return fn()


def foreach(body: Callable, data, init_states):
    """Iterate ``body(item, states) -> (outputs, new_states)`` over axis
    0 of ``data`` (``mx.nd.contrib.foreach``); returns the outputs
    stacked along a new axis 0 and the final states.  Axis 0's length is
    static, so the loop is the same eagerly and in a program."""
    data_list = _as_list(data)
    states = _as_list(init_states)
    multi_data = isinstance(data, (list, tuple))
    multi_states = isinstance(init_states, (list, tuple))
    step_outs = []
    cur = states
    for i in range(data_list[0].shape[0]):
        item = [d[i] for d in data_list]
        out, new_st = body(item if multi_data else item[0],
                           cur if multi_states else cur[0])
        step_outs.append(_as_list(out))
        cur = _as_list(new_st)
    stacked = [_stack([s[j] for s in step_outs])
               for j in range(len(step_outs[0]))] if step_outs else []
    return (stacked if len(stacked) != 1 else stacked[0],
            cur if multi_states else cur[0])


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int = None):
    """``while cond(*vars): outputs, vars = func(*vars)`` for at most
    ``max_iterations`` trips (``mx.nd.contrib.while_loop``); returns the
    trips' outputs stacked and padded with zeros to ``max_iterations``
    rows, and the final values."""
    vars_list = _as_list(loop_vars)
    multi = isinstance(loop_vars, (list, tuple))
    if max_iterations is None:
        raise _base.MXNetError("while_loop requires max_iterations")

    def call(fn, vals):
        return fn(*vals) if multi else fn(vals[0])

    if in_program():
        vals = vars_list
        active = torch.ones((), dtype=torch.bool,
                            device=_t(vars_list[0]).device)
        rows = []
        for _ in range(max_iterations):
            take = active & _flag(call(cond_fn, vals), vals[0])
            step_out, new_vals = _gated(lambda: call(func, vals), take)
            vals = [_select(take, nv, ov)
                    for nv, ov in zip(_as_list(new_vals), vals)]
            rows.append([_select(take, o, _array_op(
                "zeros_like", torch.zeros_like, o, o))
                for o in _as_list(step_out)])
            active = take
        outs = [_stack([r[j] for r in rows]) for j in range(len(rows[0]))] \
            if rows else []
        return (outs if len(outs) != 1 else outs[0],
                vals if multi else vals[0])

    cur = vars_list
    step_outs = []
    while len(step_outs) < max_iterations:
        if not _host_truth(call(cond_fn, cur)):
            break
        out, new_vals = call(func, cur)
        step_outs.append(_as_list(out))
        cur = _as_list(new_vals)
    stacked = []
    for j in range(len(step_outs[0]) if step_outs else 0):
        col = [s[j] for s in step_outs]
        st = _stack(col)
        pad = max_iterations - len(col)
        if pad > 0:
            st = _array_op(
                "concat", lambda a: torch.cat(
                    [a, a.new_zeros((pad,) + tuple(a.shape[1:]))]), st, st)
        stacked.append(st)
    return (stacked if len(stacked) != 1 else stacked[0],
            cur if multi else cur[0])


def cond(pred, then_func: Callable, else_func: Callable, inputs=None):
    """``then_func()`` if ``pred`` else ``else_func()``
    (``mx.nd.contrib.cond``).  In a program both run and the result is
    selected on the device; their outputs must agree in shape and
    dtype."""
    if not in_program() or not isinstance(_t(pred), torch.Tensor):
        return then_func() if _host_truth(pred) else else_func()
    p = _flag(pred, pred)
    a = _as_list(_gated(then_func, p))
    b = _as_list(_gated(else_func, ~p))
    outs = [_select(p, x, y) for x, y in zip(a, b)]
    return outs if len(outs) != 1 else outs[0]


def __getattr__(name):
    # upstream scripts reach contrib ops as mx.nd.contrib.<op>; the port
    # keeps them in the main op namespace, so only registered op names
    # forward through here
    if not name.startswith("_") and name in _ops.__all__:
        return getattr(_ops, name)
    raise AttributeError(name)
