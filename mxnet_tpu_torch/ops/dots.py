"""``remat='dots'``: keep a layer's products, recompute what lies between
them (the reference's ``jax.checkpoint_policies.checkpoint_dots``).

A layer that :func:`~mxnet_tpu_torch.models.transformer.run_blocks`
rematerializes with ``remat='dots'`` runs under
``torch.utils.checkpoint`` inside :func:`keep`.  There each product of
the layer (a ``Dense``'s :func:`linear`, the reference attention's two
:func:`einsum`\\ s, the MoE router's and experts' :func:`matmul`\\ s)
runs as one autograd function, :class:`_Product`:

- in the forward it multiplies and appends its output to the layer's
  list;
- in the recomputation during backward it returns the output it kept,
  in the same order, and multiplies nothing;
- its backward takes the two operands from the recomputation (the
  checkpoint recomputes and hands them over) and issues the same
  products autograd issues for the plain op.

So backward multiplies exactly as often as without remat, the work
between the products (norms, activations, dropout, B1's ctypes launch)
is recomputed, and no Python runs per aten op: the rule is one Python
call a product, not a dispatch callback on every op of the layer.
Outside :func:`keep`, each entry point is its plain torch op.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

__all__ = ["keep", "linear", "matmul", "einsum"]

_TLS = threading.local()


class _Scope:
    __slots__ = ("outputs", "replay", "cursor")

    def __init__(self, outputs, replay):
        self.outputs, self.replay, self.cursor = outputs, replay, 0

    def next(self):
        out = self.outputs[self.cursor]
        self.cursor += 1
        return out


@contextlib.contextmanager
def keep(outputs: list, replay: bool):
    """Run a ``'dots'`` layer's forward (``replay=False``: its products
    append their outputs to ``outputs``) or its recomputation
    (``replay=True``: they return those outputs in order).  Thread-local:
    the recomputation runs on autograd's device thread for CUDA
    tensors."""
    prev = getattr(_TLS, "scope", None)
    _TLS.scope = _Scope(outputs, replay)
    try:
        yield
    finally:
        _TLS.scope = prev


def _active():
    scope = getattr(_TLS, "scope", None)
    return scope if scope is not None and torch.is_grad_enabled() else None


def _grad_eq(eq):
    """The einsum equations of the two operands' gradients of ``eq``
    (two operands, every index of one in the other or the output)."""
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    return f"{out},{b}->{a}", f"{out},{a}->{b}"


class _Product(torch.autograd.Function):
    """One product of a ``'dots'`` layer: ``linear`` (x, w, bias),
    ``matmul`` (a, b of one rank, 2 or 3) or ``einsum`` (a, b, eq)."""

    @staticmethod
    def forward(ctx, scope, kind, a, b, extra):
        ctx.save_for_backward(a, b)
        ctx.kind, ctx.extra = kind, extra if kind == "einsum" else None
        if scope.replay:
            return scope.next().detach()
        if kind == "linear":
            y = F.linear(a, b, extra)
        elif kind == "matmul":
            y = torch.matmul(a, b)
        else:
            y = torch.einsum(extra, a, b)
        scope.outputs.append(y.detach())
        return y

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b, need_extra = ctx.needs_input_grad[2:5]
        da = db = dextra = None
        if ctx.kind == "linear":
            g2 = g.reshape(-1, g.shape[-1])
            if need_a:
                da = g2.mm(b).reshape(a.shape)
            if need_b:
                db = a.reshape(-1, a.shape[-1]).t().mm(g2).t()
            if need_extra:
                dextra = g2.sum(0)
        elif ctx.kind == "matmul":
            if need_a:
                da = g.matmul(b.transpose(-1, -2))
            if need_b:
                db = a.transpose(-1, -2).matmul(g)
        else:
            eq_a, eq_b = _grad_eq(ctx.extra)
            if need_a:
                da = torch.einsum(eq_a, g, b)
            if need_b:
                db = torch.einsum(eq_b, g, a)
        return None, None, da, db, dextra


def linear(x, w, bias=None):
    """``F.linear(x, w, bias)``; inside a ``'dots'`` layer, a kept
    product."""
    scope = _active()
    if scope is None:
        return F.linear(x, w, bias)
    return _Product.apply(scope, "linear", x, w, bias)


def matmul(a, b):
    """``a @ b`` of two 2-D or two 3-D tensors; inside a ``'dots'``
    layer, a kept product."""
    scope = _active()
    if scope is None:
        return torch.matmul(a, b)
    return _Product.apply(scope, "matmul", a, b, None)


def einsum(eq, a, b):
    """``torch.einsum(eq, a, b)`` of two operands; inside a ``'dots'``
    layer, a kept product."""
    scope = _active()
    if scope is None:
        return torch.einsum(eq, a, b)
    return _Product.apply(scope, "einsum", a, b, eq)
