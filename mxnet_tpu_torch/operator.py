"""``mx.operator``: Python custom operators (counterpart of
``mxnet_tpu/operator.py``).

``CustomOp`` / ``CustomOpProp`` subclasses are registered by name and
invoked through ``mx.nd.Custom(*inputs, op_type=name)``.  Under
``autograd.record()`` a custom op is one ``torch.autograd.Function``:
its forward runs ``op.forward`` and its backward ``op.backward``, both
with recording off, on NDArrays over the node's tensors.

A custom op whose body reads the host (``asnumpy``) runs eagerly only:
inside a CUDA-graph capture (a hybridized block on the card) the read
fails and the capture raises the port's typed error naming the block,
as the reference's host callback cannot run under jit.  A body of nd
ops runs inside a capture like any other.
"""
from __future__ import annotations

import inspect
from typing import List

import numpy as np
import torch

from . import base as _base
from .ndarray.ndarray import NDArray, zeros as nd_zeros
from .ndarray.ops import _as_nd

__all__ = ["CustomOp", "CustomOpProp", "register", "get_entry", "Custom"]

_custom_registry = _base.registry("custom_op")


class CustomOp:
    """Base for custom operator implementations."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst: NDArray, req: str, src):
        """Write ``src`` into ``dst`` by ``req``: ``'write'`` and
        ``'inplace'`` replace, ``'add'`` accumulates, ``'null'`` skips."""
        if req in ("null", None):
            return
        t = src._t if isinstance(src, NDArray) else \
            torch.as_tensor(np.asarray(src))
        t = t.to(device=dst._t.device, dtype=dst._t.dtype)
        if req == "add":
            t = dst._t + t
        elif req not in ("write", "inplace"):
            raise _base.MXNetError(f"unknown req {req!r}")
        if dst._alias:                  # storage owned elsewhere: write
            with torch.no_grad():
                dst._t.copy_(t)
        else:
            dst._t = t


class CustomOpProp:
    """Describes a custom op: its argument and output names, shapes and
    dtypes, and the operator it creates."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name: str):
    """Class decorator registering a ``CustomOpProp`` under
    ``reg_name``."""
    def do_register(prop_cls):
        _custom_registry.register(reg_name)(prop_cls)
        return prop_cls
    return do_register


def get_entry(name: str):
    return _custom_registry.get(name)


def _run_forward(op, out_specs, in_tensors):
    """``op.forward`` with recording off, on NDArrays over
    ``in_tensors``; returns (inputs, outputs) as NDArrays."""
    in_data = [NDArray(t) for t in in_tensors]
    dev = in_tensors[0].device
    out_data = [nd_zeros(s, ctx=dev, dtype=str(np.dtype(t)))
                for s, t in out_specs]
    prev = _base.set_recording(False)
    try:
        op.forward(_base.is_training(), ["write"] * len(out_data),
                   in_data, out_data, [])
    finally:
        _base.set_recording(prev)
    return in_data, out_data


class _CustomNode(torch.autograd.Function):
    """One custom op call as one autograd node."""

    @staticmethod
    def forward(ctx, op, out_specs, *in_tensors):
        in_data, out_data = _run_forward(op, out_specs, in_tensors)
        ctx.op, ctx.in_data, ctx.out_data = op, in_data, out_data
        ctx.is_train = _base.is_training()
        return tuple(o._t for o in out_data)

    @staticmethod
    def backward(ctx, *grads):
        in_grad = [NDArray(torch.zeros_like(d._t)) for d in ctx.in_data]
        prev = _base.set_recording(False)
        try:
            with _base.training_mode(ctx.is_train):
                ctx.op.backward(["write"] * len(in_grad),
                                [NDArray(g) for g in grads], ctx.in_data,
                                ctx.out_data, in_grad, [])
        finally:
            _base.set_recording(prev)
        return (None, None) + tuple(g._t for g in in_grad)


def Custom(*data, op_type: str, **kwargs):
    """Invoke the custom op registered as ``op_type`` on NDArray inputs
    (``mx.nd.Custom``); keyword arguments go to its prop's constructor
    where it takes them."""
    prop_cls = _custom_registry.get(op_type)
    sig = inspect.signature(prop_cls.__init__)
    prop = prop_cls(**{k: v for k, v in kwargs.items()
                       if k in sig.parameters})
    data = [_as_nd(d) for d in data]
    in_shapes = [tuple(d.shape) for d in data]
    in_shapes, out_shapes, _aux = prop.infer_shape(in_shapes)
    in_types = [d.dtype for d in data]
    _, out_types, _ = prop.infer_type(in_types)
    op = prop.create_operator(data[0].context, in_shapes, in_types)
    specs = [(tuple(s), t) for s, t in zip(out_shapes, out_types)]
    tensors = [d._t for d in data]
    if _base.is_recording() and any(t.requires_grad for t in tensors):
        with torch.enable_grad():
            outs = [NDArray(t) for t in _CustomNode.apply(op, specs,
                                                          *tensors)]
    else:
        outs = _run_forward(op, specs, tensors)[1]
    return outs[0] if len(outs) == 1 else outs
