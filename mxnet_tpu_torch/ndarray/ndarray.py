"""NDArray: MXNet's imperative array as a facade over one ``torch.Tensor``
(counterpart of ``mxnet_tpu/ndarray/ndarray.py``).

- **Autograd is torch's.**  An op builds a graph only inside
  ``autograd.record()`` (the dispatcher runs it under
  ``torch.set_grad_enabled(is_recording())``); ``attach_grad`` makes the
  tensor a leaf with a ``.grad`` buffer, and ``backward`` writes or adds
  into the buffers by each leaf's ``grad_req`` (:mod:`..autograd`).
- **In place.**  The reference's payload is immutable and an in-place
  operator rebinds it.  Here an array that owns its tensor rebinds too
  (``x += y`` makes ``x`` the sum, recorded or not, and leaves any tensor
  autograd saved untouched).  An array that *aliases* storage owned
  elsewhere — a basic-index view (``y = x[1:3]``), a parameter's
  ``data()``, a ``grad`` buffer — writes through it instead, with
  ``copy_`` under ``no_grad``, so the owner sees the write as MXNet's
  views and parameters do.
- **Devices.**  The payload's device is the array's context.  Creating an
  array with no ``ctx`` uses the innermost ``with mx.cpu():`` /
  ``with mx.gpu(i):`` scope, else the current CUDA device, and raises
  without one (:func:`..context.resolve_device`).
"""
from __future__ import annotations

import numbers
from typing import Optional, Tuple

import numpy as np
import torch

from .. import base as _base
from ..base import torch_dtype
from ..context import Context, resolve_device

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "linspace", "concatenate"]


def _numpy_dtype(dt: torch.dtype):
    """numpy's dtype for a torch dtype; bfloat16 (which numpy lacks)
    reads as its name."""
    if dt == torch.bfloat16:
        return "bfloat16"
    return torch.empty((), dtype=dt).numpy().dtype


def _ops():
    from . import ops
    return ops


class NDArray:
    """One tensor and whether it aliases storage owned elsewhere."""

    __slots__ = ("_t", "_alias", "__weakref__")

    def __init__(self, data: torch.Tensor, alias: bool = False):
        self._t = data
        self._alias = alias

    @property
    def tensor(self) -> torch.Tensor:
        """The torch tensor behind the array (shares its storage)."""
        return self._t

    # ---------------------------------------------------------------- basics
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return _numpy_dtype(self._t.dtype)

    @property
    def size(self) -> int:
        return self._t.numel()

    @property
    def ndim(self) -> int:
        return self._t.dim()

    @property
    def context(self) -> Context:
        return Context(self._t.device)

    ctx = context
    device = context

    @property
    def itemsize(self) -> int:
        return self._t.element_size()

    @property
    def flat(self):
        """A read-only flat iterator over a host copy (a writable one
        would change only the copy)."""
        a = self.asnumpy()
        a.flags.writeable = False
        return a.flat

    @property
    def T(self) -> "NDArray":
        return _ops().transpose(self)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # ------------------------------------------------------------- transfers
    def asnumpy(self) -> np.ndarray:
        """A host copy the caller owns (bfloat16 widens to float32)."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        host = t.cpu()
        a = host.numpy()
        return a.copy() if host.data_ptr() == self._t.data_ptr() else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self):
        """Wait for the work queued on the array's device (the reference's
        ``block_until_ready``)."""
        if self._t.device.type == "cuda":
            torch.cuda.current_stream(self._t.device).synchronize()

    wait_to_write = wait_to_read

    def copy(self) -> "NDArray":
        return NDArray(self._t.detach().clone())

    def copyto(self, other):
        if isinstance(other, Context):
            return self.as_in_context(other)
        with torch.no_grad():
            other._t.copy_(self._t)
        return other

    def as_in_context(self, ctx) -> "NDArray":
        return NDArray(self._t.detach().to(resolve_device(ctx)))

    as_in_ctx = as_in_context
    to_device = as_in_context


    def astype(self, dtype, copy=True) -> "NDArray":
        if not copy and torch_dtype(dtype) == self._t.dtype:
            return self
        return _ops().cast(self, dtype=dtype)

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make the array a leaf of the next recorded graph with a zeroed
        gradient buffer; ``backward`` writes (``'write'``) or adds
        (``'add'``) into it, or gives it none (``'null'``)."""
        if grad_req not in ("write", "add", "null"):
            raise _base.MXNetError(f"grad_req must be 'write', 'add' or "
                                   f"'null', not {grad_req!r}")
        t = self._t if self._t.is_leaf else self._t.detach()
        t.requires_grad_(grad_req != "null")
        t.grad = None if grad_req == "null" else torch.zeros_like(t)
        t._mx_grad_req = grad_req
        self._t = t

    @property
    def grad(self) -> "Optional[NDArray]":
        """The gradient buffer (aliasing it), None until ``attach_grad``."""
        if not self._t.is_leaf or self._t.grad is None:
            return None
        return NDArray(self._t.grad, alias=True)

    def detach(self) -> "NDArray":
        return NDArray(self._t.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # ------------------------------------------------------------- indexing
    def _index(self, k):
        if isinstance(k, tuple):
            return tuple(self._index(x) for x in k)
        if isinstance(k, NDArray):
            t = k._t
            if t.dtype == torch.bool:
                return t
            if t.is_floating_point():
                # MXNet comparisons give float 0/1 arrays: a same-shaped
                # float key is the x[x > 5] mask idiom, else an index
                if t.dim() > 0 and tuple(t.shape) == self.shape:
                    return t.bool()
                return t.long()
            return t.long()
        if isinstance(k, np.ndarray):
            return self._index(NDArray(torch.from_numpy(k).to(
                self._t.device)))
        return k

    @staticmethod
    def _is_basic(key) -> bool:
        items = key if isinstance(key, tuple) else (key,)
        return all(isinstance(k, (int, np.integer, slice, type(Ellipsis),
                                  type(None))) for k in items)

    def __getitem__(self, key):
        key = self._index(key)
        if self._is_basic(key) and not _base.is_recording():
            with torch.no_grad():
                return NDArray(self._t[key], alias=True)
        return _ops().invoke("getitem", lambda x: x[key], [self])

    def __setitem__(self, key, value):
        key = self._index(key)
        v = value._t if isinstance(value, NDArray) else value
        if not isinstance(v, (torch.Tensor, numbers.Number)):
            v = torch.as_tensor(np.asarray(v), device=self._t.device)
        recorded = _base.is_recording() and not self._alias and (
            self._t.requires_grad or
            (isinstance(v, torch.Tensor) and v.requires_grad))
        if recorded:         # out of place, so the write is in the graph
            new = self._t.clone()
            new[key] = v.to(new.dtype) if isinstance(v, torch.Tensor) else v
            self._t = new
        else:
            with torch.no_grad():
                self._t[key] = v

    # ---------------------------------------------------------- arithmetic
    def _binop(self, name, other, reflected=False):
        fn = getattr(_ops(), name)
        return fn(other, self) if reflected else fn(self, other)

    def __add__(self, o): return self._binop("add", o)
    def __radd__(self, o): return self._binop("add", o, True)
    def __sub__(self, o): return self._binop("subtract", o)
    def __rsub__(self, o): return self._binop("subtract", o, True)
    def __mul__(self, o): return self._binop("multiply", o)
    def __rmul__(self, o): return self._binop("multiply", o, True)
    def __truediv__(self, o): return self._binop("divide", o)
    def __rtruediv__(self, o): return self._binop("divide", o, True)
    def __floordiv__(self, o): return self._binop("floor_divide", o)
    def __rfloordiv__(self, o): return self._binop("floor_divide", o, True)
    def __mod__(self, o): return self._binop("mod", o)
    def __rmod__(self, o): return self._binop("mod", o, True)
    def __pow__(self, o): return self._binop("power", o)
    def __rpow__(self, o): return self._binop("power", o, True)
    def __matmul__(self, o): return self._binop("matmul", o)
    def __rmatmul__(self, o): return self._binop("matmul", o, True)
    def __neg__(self): return _ops().negative(self)
    def __abs__(self): return _ops().abs(self)

    def _inplace(self, name, other):
        res = self._binop(name, other)
        if self._alias:
            with torch.no_grad():
                self._t.copy_(res._t)
        else:
            self._t = res._t
        return self

    def __iadd__(self, o): return self._inplace("add", o)
    def __isub__(self, o): return self._inplace("subtract", o)
    def __imul__(self, o): return self._inplace("multiply", o)
    def __itruediv__(self, o): return self._inplace("divide", o)
    def __imod__(self, o): return self._inplace("mod", o)
    def __ipow__(self, o): return self._inplace("power", o)

    def __eq__(self, o): return self._binop("equal", o)
    def __ne__(self, o): return self._binop("not_equal", o)
    def __lt__(self, o): return self._binop("lesser", o)
    def __le__(self, o): return self._binop("lesser_equal", o)
    def __gt__(self, o): return self._binop("greater", o)
    def __ge__(self, o): return self._binop("greater_equal", o)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    # --------------------------------------------------- method-style ops
    def _unary(self, name, **kw):
        return getattr(_ops(), name)(self, **kw)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return _ops().reshape(self, shape=shape, **kwargs)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _ops().transpose(self, axes=axes if axes else None)

    def swapaxes(self, a1, a2): return self._unary("swapaxes", dim1=a1, dim2=a2)
    def flatten(self): return self._unary("flatten")
    def expand_dims(self, axis): return self._unary("expand_dims", axis=axis)
    def squeeze(self, axis=None): return self._unary("squeeze", axis=axis)
    def broadcast_to(self, shape): return self._unary("broadcast_to", shape=shape)
    def broadcast_like(self, other): return self.broadcast_to(other.shape)

    def sum(self, axis=None, keepdims=False, exclude=False):
        return self._unary("sum", axis=axis, keepdims=keepdims,
                           exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return self._unary("mean", axis=axis, keepdims=keepdims,
                           exclude=exclude)

    def max(self, axis=None, keepdims=False):
        return self._unary("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._unary("min", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._unary("prod", axis=axis, keepdims=keepdims)

    def argmax(self, axis=None): return self._unary("argmax", axis=axis)
    def argmin(self, axis=None): return self._unary("argmin", axis=axis)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._unary("norm", ord=ord, axis=axis, keepdims=keepdims)

    def clip(self, a_min=None, a_max=None):
        return self._unary("clip", a_min=a_min, a_max=a_max)

    def abs(self): return self._unary("abs")
    def exp(self): return self._unary("exp")
    def log(self): return self._unary("log")
    def sqrt(self): return self._unary("sqrt")
    def square(self): return self._unary("square")
    def sign(self): return self._unary("sign")
    def round(self): return self._unary("round")
    def floor(self): return self._unary("floor")
    def ceil(self): return self._unary("ceil")
    def sigmoid(self): return self._unary("sigmoid")
    def tanh(self): return self._unary("tanh")
    def relu(self): return self._unary("relu")
    def softmax(self, axis=-1): return self._unary("softmax", axis=axis)
    def log_softmax(self, axis=-1): return self._unary("log_softmax", axis=axis)
    def one_hot(self, depth, **kw): return self._unary("one_hot", depth=depth, **kw)
    def take(self, indices, axis=0): return _ops().take(self, indices, axis=axis)
    def pick(self, index, axis=-1, keepdims=False):
        return _ops().pick(self, index, axis=axis, keepdims=keepdims)
    def dot(self, other): return _ops().dot(self, other)

    def slice_axis(self, axis, begin, end):
        return _ops().slice_axis(self, axis=axis, begin=begin, end=end)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _ops().split(self, num_outputs=num_outputs, axis=axis,
                            squeeze_axis=squeeze_axis)

    def tile(self, reps): return self._unary("tile", reps=reps)
    def repeat(self, repeats, axis=None):
        return self._unary("repeat", repeats=repeats, axis=axis)
    def flip(self, axis): return self._unary("flip", axis=axis)
    def pad(self, *a, **kw): return _ops().pad(self, *a, **kw)
    def zeros_like(self): return self._unary("zeros_like")
    def ones_like(self): return self._unary("ones_like")

    # numpy-semantics methods (the reference routes them through mx.np):
    # population statistics, integer results in int32 as jax's defaults
    def _np(self, name, fn, differentiable=True):
        return _ops().invoke(name, fn, [self], differentiable=differentiable)

    def std(self, axis=None, keepdims=False):
        return self._np("std", lambda x: torch.std(
            _float(x), dim=_dims(axis), correction=0, keepdim=keepdims))

    def var(self, axis=None, keepdims=False):
        return self._np("var", lambda x: torch.var(
            _float(x), dim=_dims(axis), correction=0, keepdim=keepdims))

    def cumsum(self, axis=None):
        def f(x):
            out = torch.cumsum(x.reshape(-1) if axis is None else x,
                               dim=0 if axis is None else axis)
            return out if out.is_floating_point() else out.to(torch.int32)
        return self._np("cumsum", f)

    # sort/argsort follow numpy's semantics (a stable sort along ``axis``,
    # integer indices), as the reference's methods do; ``nd.sort`` and
    # ``nd.argsort`` keep MXNet's
    def sort(self, axis=-1):
        return self._np("sort", lambda x: _flat_or(x, axis).sort(
            dim=-1 if axis is None else axis, stable=True).values)

    def argsort(self, axis=-1):
        return self._np("argsort", lambda x: _flat_or(x, axis).argsort(
            dim=-1 if axis is None else axis, stable=True).to(torch.int32),
            differentiable=False)

    def nonzero(self):
        return tuple(self._np("nonzero", lambda x: [
            i.to(torch.int32) for i in torch.nonzero(x, as_tuple=True)],
            differentiable=False))

    def all(self, axis=None, keepdims=False):
        return self._np("all", lambda x: _reduce_bool(
            torch.all, x, axis, keepdims), differentiable=False)

    def any(self, axis=None, keepdims=False):
        return self._np("any", lambda x: _reduce_bool(
            torch.any, x, axis, keepdims), differentiable=False)

    def ravel(self): return self._np("ravel", lambda x: x.reshape(-1))

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


def _dims(axis):
    return None if axis is None else \
        (tuple(axis) if isinstance(axis, (tuple, list)) else axis)


def _float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _flat_or(x, axis):
    return x.reshape(-1) if axis is None else x


def _reduce_bool(fn, x, axis, keepdims):
    x = x.bool()
    if axis is None:
        out = fn(x)
        return out.reshape((1,) * x.dim()) if keepdims else out
    for a in sorted((axis if isinstance(axis, (tuple, list)) else (axis,)),
                    key=lambda a: a % x.dim(), reverse=True):
        x = fn(x, dim=a, keepdim=keepdims)
    return x


# ----------------------------------------------------------------- creation

def _host_array(source, dtype):
    """numpy array of ``source`` with the reference's dtype rules: float64
    becomes float32 and int64 int32 (jax's defaults), lists and scalars
    default to float32, other numpy dtypes are kept."""
    if dtype is not None:
        return np.asarray(source, dtype=_numpy_dtype(torch_dtype(dtype))
                          if torch_dtype(dtype) != torch.bfloat16
                          else np.float32)
    keep = isinstance(source, np.ndarray)
    a = np.asarray(source)
    if a.dtype == np.float64 or not keep:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def array(source, ctx=None, dtype=None) -> NDArray:
    """An array of ``source`` (NDArray, tensor, numpy array, list or
    scalar) on ``ctx`` (default: the current context)."""
    dev = resolve_device(ctx)
    if isinstance(source, NDArray):
        source = source._t
    if isinstance(source, torch.Tensor):
        t = source.detach().to(dev)
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return NDArray(t.clone() if t.data_ptr() == source.data_ptr()
                       else t)
    # a copy: the array never aliases the caller's numpy memory
    t = torch.from_numpy(np.array(_host_array(source, dtype), order="C"))
    if dtype is not None and torch_dtype(dtype) == torch.bfloat16:
        t = t.to(torch.bfloat16)
    if _pinned(ctx):
        return NDArray(t.pin_memory())
    return NDArray(t.to(dev))


def _pinned(ctx) -> bool:
    """Whether ``ctx`` asks for page-locked host memory and a card is
    there to lock it for."""
    return (isinstance(ctx, Context) and ctx.device_type == "cpu_pinned"
            and torch.cuda.is_available())


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32") -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)))


def ones(shape, ctx=None, dtype="float32") -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return NDArray(torch.full(_shape(shape), val,
                              dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    a = np.arange(start, stop, step).astype(
        _numpy_dtype(torch_dtype(dtype)))
    if repeat > 1:
        a = np.repeat(a, repeat)
    return NDArray(torch.from_numpy(a).to(resolve_device(ctx)))


def _host_dtype(dtype):
    dt = torch_dtype(dtype)
    return np.float32 if dt == torch.bfloat16 else _numpy_dtype(dt)


def eye(N, M=None, k=0, ctx=None, dtype="float32") -> NDArray:
    return array(np.eye(N, M, k, dtype=_host_dtype(dtype)), ctx=ctx,
                 dtype=dtype)


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype="float32") -> NDArray:
    return array(np.linspace(start, stop, num, endpoint=endpoint,
                             dtype=_host_dtype(dtype)), ctx=ctx, dtype=dtype)


def concatenate(arrays, axis=0) -> NDArray:
    return _ops().concat(*arrays, dim=axis)
