"""``mx.np`` — the NumPy-compatible array namespace (counterpart of
``mxnet_tpu/numpy/__init__.py``; parity: MXNet 2.x ``mx.np``).

Every name of the reference's tables is here: its ``_SIMPLE_OPS`` (those
``jax.numpy`` has, which decides the reference's list), the creation
functions, ``linalg``'s 21 names and ``random``'s samplers.  The array
type is the framework's ``NDArray`` (one facade, two namespaces).

Each op is built from torch ops and runs on its arrays' device through
the port's dispatcher (:func:`mxnet_tpu_torch.ndarray.ops.invoke`), so
autograd records it where the reference's ``_NONDIFF`` says it is
differentiable, and ``amp`` casts it as it casts an ``nd`` op.  The
names torch lacks (``polyfit``, ``piecewise``, ``lexsort``,
``partition``, ``interp``, ``histogram*``, ``convolve``, ``gradient``,
``median``'s even-count mean, the ``nan*`` reductions, ...) are built
from torch ops on the device too.  Results keep jax's dtypes with 64-bit
types off, as the reference's: float32 and int32 (indices, counts and
integer reductions included).

Host-side by nature, computed on the host: ``result_type``,
``promote_types``, ``can_cast``, ``iinfo``, ``finfo``, ``isscalar``,
``ndim``, ``shape``, ``size``, ``may_share_memory``,
``shares_memory`` and ``frombuffer`` (which reads a host buffer); the
sizes of data-dependent outputs (``nonzero``, ``unique``, ``argwhere``,
``trim_zeros``, ...) are read from the device as torch's own ops read
them.  Where the reference's wrapper raises on the host-side names
(it wraps their non-array results as arrays), the port returns numpy's
values.
"""
from __future__ import annotations

import builtins as _builtins
import math as _math

import numpy as _onp
import torch
import torch.nn.functional as _F

from .. import base as _base
from ..base import torch_dtype as _torch_dtype
from ..context import resolve_device as _resolve_device
from ..ndarray import ops as _ops
from ..ndarray.ndarray import NDArray

# the mx.np array type is the framework NDArray
ndarray = NDArray

pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None
PZERO = 0.0
NZERO = -0.0

bool_ = _onp.bool_
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
bfloat16 = torch.bfloat16
_np_version = _onp.__version__

__all__ = ["ndarray", "pi", "e", "inf", "nan", "newaxis", "dtype"]

dtype = _onp.dtype

# jax's dtypes with 64-bit types off, which the reference's results keep
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}


# ------------------------------------------------------------- plumbing

def _narrow(t):
    """``t`` in jax's 32-bit dtypes (int64 indices and counts become
    int32, float64 float32)."""
    if isinstance(t, torch.Tensor):
        dt = _NARROW.get(t.dtype)
        return t if dt is None else t.to(dt)
    if isinstance(t, (tuple, list)):
        return type(t)(_narrow(x) for x in t)
    return t


def _host_dtype(dt):
    """A numpy dtype for ``dt`` (a torch dtype, numpy dtype or name)."""
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return _onp.dtype(_onp.float32)
        return torch.empty((), dtype=dt).numpy().dtype
    if isinstance(dt, NDArray):
        return _onp.dtype(dt.dtype)
    return _onp.dtype(dt)


def _tdtype(dt):
    """A torch dtype in jax's 32-bit family, or None."""
    if dt is None:
        return None
    t = _torch_dtype(dt if not isinstance(dt, type) else _onp.dtype(dt))
    return _NARROW.get(t, t)


def _like(*xs):
    return next((x for x in _flat(xs) if isinstance(x, torch.Tensor)),
                None)


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


def _device():
    return _resolve_device(None)


def _T(x, like=None, dtype=None):
    """``x`` as a tensor: a tensor as it is; numbers, lists and numpy
    arrays on ``like``'s device (else the current context) in jax's
    32-bit dtypes."""
    if isinstance(x, NDArray):
        x = x._t
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    a = _onp.asarray(x)
    if a.dtype == _onp.float64:
        a = a.astype(_onp.float32)
    elif a.dtype == _onp.int64:
        a = a.astype(_onp.int32)
    dev = like.device if isinstance(like, torch.Tensor) else _device()
    t = torch.from_numpy(_onp.array(a, order="C")).to(dev)
    return t if dtype is None else t.to(dtype)


def _fl(t):
    """``t`` as floating point (float32 unless already floating)."""
    return t if t.is_floating_point() or t.is_complex() else \
        t.to(torch.float32)


def _swap(tree, fn):
    """``tree`` with every NDArray leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, NDArray):
        return fn(tree)
    if isinstance(tree, list):
        return [_swap(v, fn) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_swap(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _swap(v, fn) for k, v in tree.items()}
    return tree


def _out(res, like):
    """An op's result as tensors (numbers on ``like``'s device)."""
    if isinstance(res, torch.Tensor):
        return _narrow(res)
    if isinstance(res, (tuple, list)):
        return [_out(r, like) for r in res]
    return _T(res, like)


def _wrap(name, tfn, differentiable=True, export=True):
    """An ``mx.np`` op from ``tfn`` over tensors: NDArray arguments
    (positional, keyword or inside lists) become the dispatched inputs,
    everything else is closed over, and tensor results come back as
    NDArrays (a tuple or list of them as a list, as the reference's
    dispatcher gives)."""

    def op(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("ctx", None)
        kwargs.pop("device", None)
        arrs = []

        def mark(a):
            arrs.append(a)
            return _Slot(len(arrs) - 1)

        a_args, a_kw = _swap((args, kwargs), mark)

        def pure(*ts):
            fill = _Filler(ts)
            ca, ckw = fill(a_args), fill(a_kw)
            return _out(tfn(*ca, **ckw), _like(*ts))

        if not arrs:
            res = pure()
            if isinstance(res, list):
                return [NDArray(r) for r in res]
            return NDArray(res)
        r = _ops.invoke(name, pure, arrs, differentiable=differentiable)
        if out is not None:
            with torch.no_grad():
                out._t.copy_(r._t)
            return out
        return r

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = tfn.__doc__
    if export:
        __all__.append(name)
    return op


class _Slot:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


class _Filler:
    def __init__(self, ts):
        self.ts = ts

    def __call__(self, tree):
        if isinstance(tree, _Slot):
            return self.ts[tree.i]
        if isinstance(tree, list):
            return [self(v) for v in tree]
        if isinstance(tree, tuple):
            return tuple(self(v) for v in tree)
        if isinstance(tree, dict):
            return {k: self(v) for k, v in tree.items()}
        return tree


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(a % ndim for a in axis)
    return (axis % ndim,) if ndim else ()


def _keep(r, x, axis, keepdims):
    """``r`` reduced over ``axis`` of ``x``, with the reduced axes kept
    as 1 when ``keepdims``."""
    if not keepdims:
        return r
    shape = list(x.shape)
    for a in _axes(axis, x.dim()):
        shape[a] = 1
    return r.reshape(shape)


def _moved(x, axis):
    """``x`` with ``axis`` (an int, a tuple, or None for all) flattened
    into one last axis."""
    if axis is None:
        return x.reshape(-1)
    axes = _axes(axis, x.dim())
    rest = [d for d in range(x.dim()) if d not in axes]
    y = x.permute(*rest, *axes)
    return y.reshape(*[x.shape[d] for d in rest], -1)


def _int_like(r, x):
    """An integer reduction's result in the input's integer family, as
    jax's (int32 stays int32, bool counts in int32)."""
    if not x.is_floating_point() and not x.is_complex():
        return r.to(torch.int32)
    return r


# ------------------------------------------------------------ element-wise

_NONDIFF = {
    "argmax", "argmin", "argsort", "argwhere", "around", "ceil", "floor",
    "rint", "round", "round_", "sign", "trunc", "fix", "equal", "not_equal",
    "greater", "greater_equal", "less", "less_equal", "logical_and",
    "logical_or", "logical_not", "logical_xor", "isnan", "isinf", "isfinite",
    "isneginf", "isposinf", "floor_divide", "mod", "fmod", "remainder",
    "searchsorted", "count_nonzero", "nonzero", "digitize", "signbit",
    "array_equal", "allclose", "isclose", "result_type", "bincount",
    "may_share_memory", "shares_memory", "isscalar", "ndim", "shape", "size",
    "unravel_index", "ravel_multi_index", "left_shift", "right_shift",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "invert",
    "all", "any", "packbits", "unpackbits", "iinfo", "finfo",
    "gcd", "lcm",
}


# ops whose first argument is not one array (a count, a subscript
# string, a sequence of arrays)
_NOT_ARRAY_FIRST = {
    "diag_indices", "tril_indices", "triu_indices", "indices", "einsum",
    "select", "lexsort", "ravel_multi_index", "block", "concatenate",
    "stack", "vstack", "row_stack", "hstack", "dstack", "column_stack",
    "broadcast_arrays", "atleast_1d", "atleast_2d", "atleast_3d", "ix_"}


def _array_like(x):
    if isinstance(x, (_onp.ndarray, _onp.generic, bool, int, float)):
        return True
    return isinstance(x, (list, tuple)) and _builtins.all(
        isinstance(v, (bool, int, float, _onp.generic, list, tuple))
        for v in x)


def _first(tfn):
    """``tfn`` with an array-like first argument (a numpy array, a
    number, a nested list of numbers) made a tensor first."""
    def f(*args, **kw):
        if args and _array_like(args[0]):
            args = (_T(args[0], _like(*args[1:])),) + args[1:]
        return tfn(*args, **kw)
    return f


def _def(name, tfn):
    if name not in _NOT_ARRAY_FIRST:
        tfn = _first(tfn)
    globals()[name] = _wrap(name, tfn, differentiable=name not in _NONDIFF)


def _fun(tf):
    """A float function (an integer input computes in float32)."""
    def f(x, *a, **k):
        return tf(_fl(x), *a, **k)
    return f


def _bin(tf):
    def f(x1, x2, *a, **k):
        t1 = x1 if isinstance(x1, torch.Tensor) else None
        t2 = x2 if isinstance(x2, torch.Tensor) else None
        like = t1 if t1 is not None else t2
        if t1 is None and not isinstance(x1, (int, float)):
            x1 = _T(x1, like)
        if t2 is None and not isinstance(x2, (int, float)):
            x2 = _T(x2, like)
        if not isinstance(x1, torch.Tensor):
            x1 = torch.tensor(x1, dtype=torch.result_type(x2, x1),
                              device=x2.device)
        if not isinstance(x2, torch.Tensor):
            x2 = torch.tensor(x2, dtype=torch.result_type(x1, x2),
                              device=x1.device)
        return tf(x1, x2, *a, **k)
    return f


def _fbin(tf):
    def g(a, b, *r, **k):
        dt = torch.promote_types(a.dtype, b.dtype)
        if not (dt.is_floating_point or dt.is_complex):
            dt = torch.float32
        return tf(a.to(dt), b.to(dt), *r, **k)
    return _bin(g)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _round(x, decimals=0, out=None):
    if not (x.is_floating_point() or x.is_complex()):
        return x
    return torch.round(x, decimals=decimals)


def _angle(x, deg=False):
    r = torch.angle(_fl(x))
    return torch.rad2deg(r) if deg else r


def _nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    if not x.is_floating_point():
        return x
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


for _n, _tf in [
        ("abs", torch.abs), ("absolute", torch.abs),
        ("square", torch.square), ("negative", torch.neg),
        ("positive", torch.positive), ("sign", torch.sign),
        ("ceil", lambda x: x if not x.is_floating_point() else x.ceil()),
        ("floor", lambda x: x if not x.is_floating_point() else x.floor()),
        ("rint", lambda x: x if not x.is_floating_point() else x.round()),
        ("trunc", lambda x: x if not x.is_floating_point() else x.trunc()),
        ("real", lambda x: x.real if x.is_complex() else x),
        ("imag", lambda x: x.imag if x.is_complex() else
         torch.zeros_like(x)),
        ("conj", lambda x: x.conj() if x.is_complex() else x),
        ("conjugate", lambda x: x.conj() if x.is_complex() else x),
        ("signbit", torch.signbit), ("logical_not", torch.logical_not),
        ("isnan", torch.isnan), ("isinf", torch.isinf),
        ("isfinite", torch.isfinite), ("isneginf", torch.isneginf),
        ("isposinf", torch.isposinf), ("invert", torch.bitwise_not)]:
    _def(_n, _tf)
for _n, _tf in [
        ("sqrt", torch.sqrt), ("cbrt", _cbrt),
        ("reciprocal", torch.reciprocal), ("exp", torch.exp),
        ("expm1", torch.expm1), ("exp2", torch.exp2), ("log", torch.log),
        ("log2", torch.log2), ("log10", torch.log10),
        ("log1p", torch.log1p), ("sin", torch.sin), ("cos", torch.cos),
        ("tan", torch.tan), ("arcsin", torch.asin), ("arccos", torch.acos),
        ("arctan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("tanh", torch.tanh), ("arcsinh", torch.asinh),
        ("arccosh", torch.acosh), ("arctanh", torch.atanh),
        ("deg2rad", torch.deg2rad), ("rad2deg", torch.rad2deg),
        ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
        ("sinc", torch.sinc), ("i0", torch.special.i0), ("angle", _angle)]:
    _def(_n, _fun(_tf))
_def("around", _round)
_def("round", _round)
_def("nan_to_num", _nan_to_num)
_def("frexp", _fun(lambda x: tuple(torch.frexp(x))))
_def("modf", _fun(lambda x: (x - torch.trunc(x), torch.trunc(x))))


def _true_div(a, b):
    return torch.true_divide(_fl(a) if not b.is_floating_point() else a, b)


def _floor_div(a, b):
    return torch.floor_divide(a, b)


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        dt = torch.float32
    return torch.isclose(a.to(dt), b.to(dt), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def _allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(_isclose(a, b, rtol, atol, equal_nan))


def _array_equal(a1, a2, equal_nan=False):
    a1, a2 = _T(a1), _T(a2, a1)
    if tuple(a1.shape) != tuple(a2.shape):
        return torch.tensor(False, device=a1.device)
    eq = a1 == a2
    if equal_nan and a1.is_floating_point():
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return torch.all(eq)


def _ldexp(x1, x2):
    return torch.ldexp(_fl(x1), x2.to(torch.int32))


def _heaviside(x1, x2):
    x1 = _fl(x1)
    return torch.heaviside(x1, x2.to(x1.dtype))


def _float_power(a, b):
    return torch.float_power(a, b).to(torch.promote_types(
        _fl(a).dtype, _fl(b).dtype))


def _divmod(a, b):
    return (torch.floor_divide(a, b), torch.remainder(a, b))


for _n, _tf in [
        ("add", torch.add), ("subtract", torch.sub),
        ("multiply", torch.mul), ("divide", _true_div),
        ("true_divide", _true_div), ("floor_divide", _floor_div),
        ("mod", torch.remainder), ("remainder", torch.remainder),
        ("fmod", torch.fmod), ("power", torch.pow),
        ("maximum", torch.maximum), ("minimum", torch.minimum),
        ("fmax", torch.fmax), ("fmin", torch.fmin),
        ("equal", torch.eq), ("not_equal", torch.ne),
        ("greater", torch.gt), ("greater_equal", torch.ge),
        ("less", torch.lt), ("less_equal", torch.le),
        ("logical_and", torch.logical_and),
        ("logical_or", torch.logical_or),
        ("logical_xor", torch.logical_xor),
        ("bitwise_and", torch.bitwise_and),
        ("bitwise_or", torch.bitwise_or),
        ("bitwise_xor", torch.bitwise_xor),
        ("left_shift", torch.bitwise_left_shift),
        ("right_shift", torch.bitwise_right_shift),
        ("gcd", torch.gcd), ("lcm", torch.lcm), ("ldexp", _ldexp),
        ("heaviside", _heaviside), ("isclose", _isclose),
        ("allclose", _allclose), ("divmod", _divmod)]:
    _def(_n, _bin(_tf))
for _n, _tf in [
        ("float_power", _float_power), ("logaddexp", torch.logaddexp),
        ("logaddexp2", torch.logaddexp2), ("arctan2", torch.atan2),
        ("hypot", torch.hypot), ("copysign", torch.copysign),
        ("nextafter", torch.nextafter)]:
    _def(_n, _fbin(_tf))
_def("array_equal", _array_equal)


def _clip(a, a_min=None, a_max=None):
    lo = None if a_min is None else _T(a_min, a)
    hi = None if a_max is None else _T(a_max, a)
    return torch.clamp(a, lo, hi)


_def("clip", _clip)


# --------------------------------------------------------------- reductions

def _sum(a, axis=None, dtype=None, keepdims=False, initial=None,
         where=None):
    r = torch.sum(a, dim=_axes(axis, a.dim()), keepdim=keepdims) \
        if a.dim() else a.clone()
    if initial is not None:
        r = r + initial
    r = _int_like(r, a)
    return r if dtype is None else r.to(_tdtype(dtype))


def _prod(a, axis=None, dtype=None, keepdims=False, initial=None,
          where=None):
    r = torch.prod(_moved(a, axis), dim=-1) if a.dim() else a.clone()
    if initial is not None:
        r = r * initial
    r = _keep(_int_like(r, a), a, axis, keepdims)
    return r if dtype is None else r.to(_tdtype(dtype))


def _mean(a, axis=None, dtype=None, keepdims=False, where=None):
    return torch.mean(_fl(a), dim=_axes(axis, a.dim()), keepdim=keepdims)


def _var(a, axis=None, dtype=None, ddof=0, keepdims=False, where=None,
         correction=None):
    return torch.var(_fl(a), dim=_axes(axis, a.dim()),
                     correction=ddof if correction is None else correction,
                     keepdim=keepdims)


def _std(a, axis=None, dtype=None, ddof=0, keepdims=False, where=None,
         correction=None):
    return torch.sqrt(_var(a, axis, dtype, ddof, keepdims, where,
                           correction))


def _amin(a, axis=None, keepdims=False, initial=None, where=None):
    r = torch.amin(a, dim=_axes(axis, a.dim()), keepdim=keepdims)
    return r if initial is None else torch.clamp(r, max=initial)


def _amax(a, axis=None, keepdims=False, initial=None, where=None):
    r = torch.amax(a, dim=_axes(axis, a.dim()), keepdim=keepdims)
    return r if initial is None else torch.clamp(r, min=initial)


def _arg(fn):
    def f(a, axis=None, keepdims=False):
        if axis is None:
            r = fn(a.reshape(-1))
            return r.reshape((1,) * a.dim()) if keepdims else r
        return fn(a, dim=axis, keepdim=keepdims)
    return f


def _bool_red(fn):
    def f(a, axis=None, keepdims=False, where=None):
        b = a.bool()
        r = fn(_moved(b, axis), dim=-1)
        return _keep(r, a, axis, keepdims)
    return f


def _ptp(a, axis=None, keepdims=False):
    return _amax(a, axis, keepdims) - _amin(a, axis, keepdims)


def _quantile(a, q, axis=None, method="linear", keepdims=False,
              interpolation=None, nan=False):
    x = _fl(a)
    qt = _T(q, x, torch.float32).to(x.dtype)
    fn = torch.nanquantile if nan else torch.quantile
    if axis is None:
        r = fn(x.reshape(-1), qt, dim=0)
    else:
        r = fn(_moved(x, axis), qt, dim=-1)
    if keepdims:
        shape = [1 if d in _axes(axis, x.dim()) else s
                 for d, s in enumerate(x.shape)]
        r = r.reshape(tuple(qt.shape) + tuple(shape))
    return r


def _median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile(a, 0.5, axis, keepdims=keepdims)


def _nanmedian(a, axis=None, out=None, overwrite_input=False,
               keepdims=False):
    return _quantile(a, 0.5, axis, keepdims=keepdims, nan=True)


def _percentile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, nan=False):
    return _quantile(a, _T(q, a, torch.float32) / 100.0, axis, method,
                     keepdims, nan=nan)


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _fl(a)
    if weights is None:
        avg = _mean(a, axis, keepdims=keepdims)
        n = torch.tensor(a.numel() / _builtins.max(avg.numel(), 1),
                         dtype=a.dtype, device=a.device)
        return (avg, n.expand_as(avg)) if returned else avg
    w = _T(weights, a).to(a.dtype)
    if w.dim() == 1 and a.dim() > 1 and axis is not None:
        shape = [1] * a.dim()
        shape[axis] = -1
        w = w.reshape(shape)
    ws = torch.sum(w.expand_as(a), dim=_axes(axis, a.dim()),
                   keepdim=keepdims)
    avg = torch.sum(a * w, dim=_axes(axis, a.dim()), keepdim=keepdims) / ws
    return (avg, ws) if returned else avg


def _count_nonzero(a, axis=None, keepdims=False):
    r = torch.count_nonzero(a, dim=_axes(axis, a.dim()))
    return _keep(r, a, axis, keepdims).to(torch.int32)


def _cum(fn):
    def f(a, axis=None, dtype=None, out=None):
        x = a.reshape(-1) if axis is None else a
        r = fn(x, dim=0 if axis is None else axis)
        r = _int_like(r, a)
        return r if dtype is None else r.to(_tdtype(dtype))
    return f


def _cumulative_sum(x, axis=None, dtype=None, include_initial=False):
    if axis is None:
        if x.dim() > 1:
            raise ValueError("axis must be given for a multi-dimensional "
                             "input")
        axis = 0
    r = _int_like(torch.cumsum(x, dim=axis), x)
    if include_initial:
        shape = list(r.shape)
        shape[axis] = 1
        r = torch.cat([torch.zeros(shape, dtype=r.dtype, device=r.device),
                       r], dim=axis)
    return r if dtype is None else r.to(_tdtype(dtype))


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    y = _fl(y)
    if x is not None:
        return torch.trapezoid(y, _T(x, y).to(y.dtype), dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


def _nan_fill(a, v):
    return torch.where(torch.isnan(a), torch.full_like(a, v), a) \
        if a.is_floating_point() else a


def _nan_var(a, axis=None, dtype=None, ddof=0, keepdims=False,
             where=None):
    x = _fl(a)
    ok = ~torch.isnan(x)
    dims = _axes(axis, x.dim())
    n = ok.sum(dim=dims, keepdim=True).to(x.dtype)
    mean = torch.nansum(x, dim=dims, keepdim=True) / n
    dev = torch.where(ok, x - mean, torch.zeros_like(x))
    r = (dev * dev).sum(dim=dims, keepdim=True) / (n - ddof)
    return r if keepdims else r.reshape([s for d, s in enumerate(x.shape)
                                         if d not in dims])


def _nan_ext(fn, fill):
    def f(a, axis=None, keepdims=False, initial=None, where=None):
        x = _fl(a)
        r = fn(_nan_fill(x, fill), axis, keepdims)
        allnan = torch.all(_moved(torch.isnan(x), axis), dim=-1)
        allnan = _keep(allnan, x, axis, keepdims)
        return torch.where(allnan, torch.full_like(r, float("nan")), r)
    return f


def _nan_arg(fn, fill):
    def f(a, axis=None, keepdims=False):
        return fn(_nan_fill(_fl(a), fill), axis, keepdims)
    return f


for _n, _tf in [
        ("sum", _sum), ("prod", _prod), ("mean", _mean), ("std", _std),
        ("var", _var), ("min", _amin), ("max", _amax), ("amin", _amin),
        ("amax", _amax),
        ("nansum", lambda a, axis=None, dtype=None, keepdims=False, **k:
         _sum(_nan_fill(a, 0.0), axis, dtype, keepdims)),
        ("nanprod", lambda a, axis=None, dtype=None, keepdims=False, **k:
         _prod(_nan_fill(a, 1.0), axis, dtype, keepdims)),
        ("nanmean", lambda a, axis=None, dtype=None, keepdims=False, **k:
         torch.nanmean(_fl(a), dim=_axes(axis, a.dim()), keepdim=keepdims)),
        ("nanvar", _nan_var),
        ("nanstd", lambda *a, **k: torch.sqrt(_nan_var(*a, **k))),
        ("nanmin", _nan_ext(_amin, float("inf"))),
        ("nanmax", _nan_ext(_amax, float("-inf"))),
        ("argmax", _arg(torch.argmax)), ("argmin", _arg(torch.argmin)),
        ("nanargmax", _nan_arg(_arg(torch.argmax), float("-inf"))),
        ("nanargmin", _nan_arg(_arg(torch.argmin), float("inf"))),
        ("all", _bool_red(torch.all)), ("any", _bool_red(torch.any)),
        ("ptp", _ptp), ("median", _median), ("nanmedian", _nanmedian),
        ("quantile", _quantile),
        ("nanquantile", lambda *a, **k: _quantile(*a, nan=True, **k)),
        ("percentile", _percentile),
        ("nanpercentile", lambda *a, **k: _percentile(*a, nan=True, **k)),
        ("average", _average), ("count_nonzero", _count_nonzero),
        ("cumsum", _cum(torch.cumsum)), ("cumprod", _cum(torch.cumprod)),
        ("nancumsum", lambda a, *r, **k: _cum(torch.cumsum)(
            _nan_fill(a, 0.0), *r, **k)),
        ("nancumprod", lambda a, *r, **k: _cum(torch.cumprod)(
            _nan_fill(a, 1.0), *r, **k)),
        ("trapezoid", _trapezoid), ("cumulative_sum", _cumulative_sum)]:
    _def(_n, _tf)


# ---------------------------------------------------- linear algebra-ish

def _dot(a, b, out=None):
    a, b = _T(a), _T(b, a)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1],
                                       [_builtins.max(b.dim() - 2, 0)]))


def _vdot(a, b):
    a, b = _T(a), _T(b, a)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _inner(a, b):
    a, b = _T(a), _T(b, a)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 1]))


def _outer(a, b, out=None):
    a, b = _T(a), _T(b, a)
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _tensordot(a, b, axes=2):
    a, b = _T(a), _T(b, a)
    if isinstance(axes, int):
        return torch.tensordot(a, b, dims=axes)
    return torch.tensordot(a, b, dims=(list(_seq(axes[0])),
                                       list(_seq(axes[1]))))


def _seq(x):
    return x if isinstance(x, (list, tuple)) else (x,)


def _einsum(subscripts, *operands, **kw):
    ops_ = [_T(o) for o in operands]
    return torch.einsum(subscripts, *ops_)


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _T(a), _T(b, a)
    if axis is not None:
        axisa = axisb = axisc = axis
    r = torch.linalg.cross(torch.movedim(a, axisa, -1),
                           torch.movedim(b, axisb, -1))
    return torch.movedim(r, -1, axisc)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    r = torch.diagonal(a, offset, axis1, axis2).sum(-1)
    return _int_like(r, a)


def _diag(v, k=0):
    return torch.diag(v, k)


def _diag_indices(n, ndim=2):
    i = torch.arange(n, dtype=torch.int32, device=_device())
    return tuple(i for _ in range(ndim))


for _n, _tf in [
        ("dot", _dot), ("vdot", _vdot), ("inner", _inner),
        ("outer", _outer),
        ("matmul", lambda a, b, **k: torch.matmul(_T(a), _T(b, a))),
        ("tensordot", _tensordot), ("einsum", _einsum),
        ("kron", lambda a, b: torch.kron(_T(a), _T(b, a))),
        ("cross", _cross), ("trace", _trace),
        ("diagonal", lambda a, offset=0, axis1=0, axis2=1: torch.diagonal(
            a, offset, axis1, axis2)),
        ("diag", _diag),
        ("diagflat", lambda v, k=0: torch.diagflat(_T(v), k)),
        ("diag_indices", _diag_indices)]:
    _def(_n, _tf)


# --------------------------------------------------------------- shapes

def _reshape(a, newshape=None, order="C", shape=None):
    s = shape if shape is not None else newshape
    return torch.reshape(_T(a), (s,) if isinstance(s, int) else tuple(s))


def _transpose(a, axes=None):
    a = _T(a)
    if axes is None:
        return a.permute(*reversed(range(a.dim())))
    return a.permute(*axes)


def _rollaxis(a, axis, start=0):
    n = a.dim()
    axis, start = axis % n, (start + n if start < 0 else start)
    if axis < start:
        start -= 1
    if axis == start:
        return a
    order = [d for d in range(n) if d != axis]
    order.insert(start, axis)
    return a.permute(*order)


def _expand_dims(a, axis):
    a = _T(a)
    out_nd = a.dim() + len(_seq(axis))
    for ax in sorted(x % out_nd for x in _seq(axis)):
        a = a.unsqueeze(ax)
    return a


def _squeeze(a, axis=None):
    a = _T(a)
    if axis is None:
        return a.squeeze()
    for ax in sorted((x % a.dim() for x in _seq(axis)), reverse=True):
        if a.shape[ax] != 1:
            raise ValueError(f"cannot squeeze axis {ax} of size "
                             f"{a.shape[ax]}")
        a = a.squeeze(ax)
    return a


def _broadcast_to(a, shape):
    return torch.broadcast_to(_T(a), (shape,) if isinstance(shape, int)
                              else tuple(shape))


def _atleast(nd):
    def one(x):
        x = _T(x)
        if x.dim() >= nd:
            return x
        if nd == 1:
            return x.reshape(1)
        if nd == 2:
            return x.reshape(1, -1) if x.dim() == 1 else x.reshape(1, 1)
        if x.dim() == 0:
            return x.reshape(1, 1, 1)
        if x.dim() == 1:
            return x.reshape(1, -1, 1)
        return x.unsqueeze(-1)

    def f(*arys):
        res = [one(x) for x in arys]
        return res[0] if len(res) == 1 else res
    return f


def _flip(m, axis=None):
    m = _T(m)
    return torch.flip(m, dims=_axes(axis, m.dim()))


def _roll(a, shift, axis=None):
    a = _T(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def _repeat(a, repeats, axis=None):
    a = _T(a)
    r = _T(repeats, a) if not isinstance(repeats, int) else repeats
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), r)
    return torch.repeat_interleave(a, r, dim=axis)


def _pad_widths(pad_width, ndim):
    pw = _onp.asarray(pad_width, dtype=_onp.int64)
    if pw.ndim == 0:
        return [(int(pw), int(pw))] * ndim
    if pw.ndim == 1:
        if pw.size == 1:
            return [(int(pw[0]), int(pw[0]))] * ndim
        return [(int(pw[0]), int(pw[1]))] * ndim
    if pw.shape[0] == 1:
        return [(int(pw[0, 0]), int(pw[0, 1]))] * ndim
    return [(int(b), int(a)) for b, a in pw]


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        j = torch.remainder(i, period)
        return torch.where(j < n, j, period - j)
    if mode == "symmetric":
        period = 2 * n
        j = torch.remainder(i, period)
        return torch.where(j < n, j, period - 1 - j)
    raise NotImplementedError(f"pad mode {mode!r}")


def _pad(array, pad_width, mode="constant", constant_values=0, **kw):
    x = _T(array)
    widths = _pad_widths(pad_width, x.dim())
    if mode == "constant":
        flat = []
        for b, a in reversed(widths):
            flat += [b, a]
        if not _onp.isscalar(constant_values) and \
                _onp.ndim(constant_values) > 0:
            raise NotImplementedError("per-axis constant_values")
        return _F.pad(x, flat, value=float(constant_values))
    for ax, (b, a) in enumerate(widths):
        if b or a:
            x = x.index_select(ax, _pad_index(x.shape[ax], b, a, mode,
                                              x.device))
    return x


def _flatnonzero(a):
    return torch.nonzero(_T(a).reshape(-1)).reshape(-1).to(torch.int32)


for _n, _tf in [
        ("reshape", _reshape),
        ("ravel", lambda a, order="C": _T(a).reshape(-1)),
        ("transpose", _transpose),
        ("swapaxes", lambda a, axis1, axis2: _T(a).transpose(axis1, axis2)),
        ("moveaxis", lambda a, source, destination: torch.movedim(
            _T(a), source, destination)),
        ("rollaxis", _rollaxis), ("expand_dims", _expand_dims),
        ("squeeze", _squeeze), ("broadcast_to", _broadcast_to),
        ("broadcast_arrays", lambda *args: list(torch.broadcast_tensors(
            *[_T(a) for a in args]))),
        ("atleast_1d", _atleast(1)), ("atleast_2d", _atleast(2)),
        ("atleast_3d", _atleast(3)), ("flip", _flip),
        ("fliplr", lambda m: torch.flip(_T(m), dims=(1,))),
        ("flipud", lambda m: torch.flip(_T(m), dims=(0,))),
        ("rot90", lambda m, k=1, axes=(0, 1): torch.rot90(_T(m), k,
                                                          list(axes))),
        ("roll", _roll),
        ("tile", lambda A, reps: torch.tile(_T(A), tuple(_seq(reps)))),
        ("repeat", _repeat), ("pad", _pad), ("flatnonzero", _flatnonzero)]:
    _def(_n, _tf)


# ------------------------------------------------ joining / splitting

def _concatenate(arrays, axis=0, dtype=None, **kw):
    ts = [_T(a) for a in arrays]
    like = ts[0]
    ts = [_T(a, like) for a in ts]
    if axis is None:
        ts = [t.reshape(-1) for t in ts]
        axis = 0
    dt = _result(ts)
    r = torch.cat([t.to(dt) for t in ts], dim=axis)
    return r if dtype is None else r.to(_tdtype(dtype))


def _result(ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _stack(arrays, axis=0, out=None, dtype=None):
    ts = [_T(a) for a in arrays]
    dt = _result(ts)
    r = torch.stack([t.to(dt) for t in ts], dim=axis)
    return r if dtype is None else r.to(_tdtype(dtype))


def _vstack(tup, dtype=None):
    return _concatenate(_atleast(2)(*tup) if len(tup) > 1 else
                        [_atleast(2)(tup[0])], 0, dtype)


def _hstack(tup, dtype=None):
    ts = [_atleast(1)(t) for t in tup]
    return _concatenate(ts, 0 if ts[0].dim() == 1 else 1, dtype)


def _dstack(tup):
    return _concatenate([_atleast(3)(t) for t in tup], 2)


def _column_stack(tup):
    ts = [_T(t) for t in tup]
    return _concatenate([t.reshape(-1, 1) if t.dim() < 2 else t
                         for t in ts], 1)


def _split(ary, indices_or_sections, axis=0, strict=True):
    x = _T(ary)
    ios = indices_or_sections
    if isinstance(ios, int):
        if strict and x.shape[axis] % ios:
            raise ValueError("array split does not result in an equal "
                             "division")
        return list(torch.tensor_split(x, ios, dim=axis))
    return list(torch.tensor_split(x, [int(i) for i in ios], dim=axis))


def _append(arr, values, axis=None):
    a, v = _T(arr), _T(values, _T(arr))
    if axis is None:
        return _concatenate([a.reshape(-1), v.reshape(-1)], 0)
    return _concatenate([a, v], axis)


def _insert(arr, obj, values, axis=None):
    x = _T(arr)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    if not isinstance(obj, (int, _onp.integer)):
        raise NotImplementedError("insert takes one integer index")
    n = x.shape[axis]
    obj = int(obj) + (n if obj < 0 else 0)
    v = _T(values, x).to(x.dtype)
    while v.dim() < x.dim():
        v = v.unsqueeze(0)
    v = torch.movedim(v, 0, axis)
    shape = list(x.shape)
    shape[axis] = v.shape[axis]
    v = torch.broadcast_to(v, shape)
    return torch.cat([x.narrow(axis, 0, obj), v,
                      x.narrow(axis, obj, n - obj)], dim=axis)


def _delete(arr, obj, axis=None):
    x = _T(arr)
    if axis is None:
        x, axis = x.reshape(-1), 0
    n = x.shape[axis]
    keep = torch.ones(n, dtype=torch.bool, device=x.device)
    if isinstance(obj, slice):
        keep[obj] = False
    else:
        idx = _T(obj, x).to(torch.int64).reshape(-1)
        keep[torch.remainder(idx, n)] = False
    return x.index_select(axis, keep.nonzero().reshape(-1))


def _resize(a, new_shape):
    x = _T(a).reshape(-1)
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    n = int(_onp.prod(shape))
    if x.numel() == 0:
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    idx = torch.remainder(torch.arange(n, device=x.device), x.numel())
    return x[idx].reshape(shape)


for _n, _tf in [
        ("concatenate", _concatenate), ("stack", _stack),
        ("vstack", _vstack), ("row_stack", _vstack), ("hstack", _hstack),
        ("dstack", _dstack), ("column_stack", _column_stack),
        ("split", _split),
        ("array_split", lambda ary, ios, axis=0: _split(ary, ios, axis,
                                                        strict=False)),
        ("hsplit", lambda ary, ios: _split(ary, ios, 1 if _T(ary).dim() > 1
                                           else 0)),
        ("vsplit", lambda ary, ios: _split(ary, ios, 0)),
        ("dsplit", lambda ary, ios: _split(ary, ios, 2)),
        ("append", _append), ("insert", _insert), ("delete", _delete),
        ("resize", _resize)]:
    _def(_n, _tf)


# --------------------------------------------------- indexing / selection

def _where(condition, x=None, y=None):
    c = _T(condition)
    if x is None and y is None:
        return _nonzero(c)
    like = c
    xt = x if isinstance(x, (int, float)) else _T(x, like)
    yt = y if isinstance(y, (int, float)) else _T(y, like)
    if isinstance(xt, torch.Tensor) and isinstance(yt, torch.Tensor):
        dt = torch.promote_types(xt.dtype, yt.dtype)
        xt, yt = xt.to(dt), yt.to(dt)
    return torch.where(c.bool(), xt, yt)


def _nonzero(a):
    return tuple(i.to(torch.int32) for i in
                 torch.nonzero(_T(a), as_tuple=True))


def _take(a, indices, axis=None, out=None, mode=None, **kw):
    x = _T(a)
    idx = _T(indices, x).to(torch.int64)
    if axis is None:
        x, axis = x.reshape(-1), 0
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    flat = x.index_select(axis, idx.reshape(-1))
    return flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) +
                        tuple(x.shape[axis + 1:]))


def _take_along_axis(arr, indices, axis, **kw):
    x = _T(arr)
    idx = _T(indices, x).to(torch.int64)
    if axis is None:
        return torch.take_along_dim(x.reshape(-1), idx.reshape(-1))
    n = x.shape[axis]
    return torch.take_along_dim(x, torch.where(idx < 0, idx + n, idx),
                                dim=axis)


def _choose(a, choices, out=None, mode="raise"):
    idx = _T(a).to(torch.int64)
    cs = torch.stack(torch.broadcast_tensors(*[_T(c, idx) for c in choices]))
    idx, _ = torch.broadcast_tensors(idx, cs[0])
    return torch.gather(cs, 0, idx.unsqueeze(0)).squeeze(0)


def _compress(condition, a, axis=None, out=None):
    x = _T(a)
    keep = _T(condition, x).bool().reshape(-1).nonzero().reshape(-1)
    if axis is None:
        return x.reshape(-1).index_select(0, keep)
    return x.index_select(axis, keep)


def _extract(condition, arr):
    x = _T(arr)
    return x.reshape(-1)[_T(condition, x).bool().reshape(-1)]


def _searchsorted(a, v, side="left", sorter=None, **kw):
    a = _T(a)
    v = _T(v, a)
    if sorter is not None:
        a = a[_T(sorter, a).to(torch.int64)]
    dt = torch.promote_types(a.dtype, v.dtype)
    return torch.searchsorted(a.to(dt), v.to(dt),
                              right=side == "right").to(torch.int32)


def _unravel_index(indices, shape):
    idx = _T(indices).to(torch.int64)
    out = []
    for s in reversed(tuple(_seq(shape))):
        out.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return tuple(o.to(torch.int32) for o in reversed(out))


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_T(m).to(torch.int64) for m in multi_index]
    flat = torch.zeros_like(idx[0])
    for i, d in zip(idx, dims):
        flat = flat * int(d) + i
    return flat.to(torch.int32)


def _tri_indices(lower):
    def f(n, k=0, m=None):
        fn = torch.tril_indices if lower else torch.triu_indices
        r = fn(n, n if m is None else m, offset=k, device=_device())
        return (r[0].to(torch.int32), r[1].to(torch.int32))
    return f


def _indices(dimensions, dtype=int, sparse=False):
    dev = _device()
    dt = _tdtype(dtype)
    grids = torch.meshgrid(*[torch.arange(d, device=dev, dtype=dt)
                             for d in dimensions], indexing="ij")
    return torch.stack(grids) if grids else torch.zeros(
        (0,), dtype=dt, device=dev)


def _ix(*args):
    out = []
    n = len(args)
    for k, a in enumerate(args):
        t = _T(a)
        if t.dtype == torch.bool:
            t = t.nonzero().reshape(-1).to(torch.int32)
        shape = [1] * n
        shape[k] = t.numel()
        out.append(t.reshape(shape))
    return tuple(out)


def _select(condlist, choicelist, default=0):
    like = _like(*condlist, *choicelist)
    choices = [_T(c, like) for c in choicelist]
    dt = _result(choices)
    out = torch.full_like(choices[0], default, dtype=dt)
    for cond, ch in reversed(list(zip(condlist, choices))):
        out = torch.where(_T(cond, like).bool(), ch.to(dt), out)
    return out


def _piecewise(x, condlist, funclist, *args, **kw):
    x = _T(x)
    conds = [_T(c, x).bool() for c in condlist]
    out = torch.zeros_like(x)
    if len(funclist) == len(conds) + 1:
        conds.append(~torch.stack(conds).any(0) if conds else
                     torch.ones_like(x, dtype=torch.bool))
    for c, fn in zip(conds, funclist):
        val = fn(x, *args, **kw) if callable(fn) else torch.full_like(
            x, fn)
        out = torch.where(c, _T(val, x).to(x.dtype), out)
    return out


def _put_along_axis(arr, indices, values, axis, inplace=True, mode=None):
    if inplace:
        raise ValueError("put_along_axis takes inplace=False (arrays are "
                         "not written in place)")
    x = _T(arr)
    idx = _T(indices, x).to(torch.int64)
    if axis is None:
        flat = x.reshape(-1)
        return flat.scatter(0, idx.reshape(-1), torch.broadcast_to(
            _T(values, x).to(x.dtype), (idx.numel(),))).reshape(x.shape)
    v = torch.broadcast_to(_T(values, x).to(x.dtype), idx.shape)
    return torch.scatter(x, axis, idx, v)


for _n, _tf in [
        ("where", _where), ("take", _take),
        ("take_along_axis", _take_along_axis), ("choose", _choose),
        ("compress", _compress), ("extract", _extract),
        ("searchsorted", _searchsorted),
        ("argwhere", lambda a: torch.argwhere(_T(a)).to(torch.int32)),
        ("nonzero", _nonzero), ("unravel_index", _unravel_index),
        ("ravel_multi_index", _ravel_multi_index),
        ("tril", lambda m, k=0: torch.tril(_T(m), k)),
        ("triu", lambda m, k=0: torch.triu(_T(m), k)),
        ("tril_indices", _tri_indices(True)),
        ("triu_indices", _tri_indices(False)), ("indices", _indices),
        ("ix_", _ix), ("select", _select), ("piecewise", _piecewise),
        ("put_along_axis", _put_along_axis)]:
    _def(_n, _tf)


# ------------------------------------------------------------- sorting

def _sort(a, axis=-1, kind=None, order=None, stable=True, descending=False):
    x = _T(a)
    if axis is None:
        x, axis = x.reshape(-1), -1
    return torch.sort(x, dim=axis, stable=True, descending=descending)[0]


def _argsort(a, axis=-1, kind=None, order=None, stable=True,
             descending=False):
    x = _T(a)
    if axis is None:
        x, axis = x.reshape(-1), -1
    return torch.sort(x, dim=axis, stable=True,
                      descending=descending)[1].to(torch.int32)


def _lexsort(keys, axis=-1):
    ks = [_T(k) for k in keys] if isinstance(keys, (list, tuple)) else \
        list(_T(keys).unbind(0))
    idx = torch.arange(ks[0].shape[axis], device=ks[0].device)
    for k in ks:                  # the last key is the primary one
        order = torch.sort(k.index_select(axis, idx), dim=axis,
                           stable=True)[1]
        idx = idx[order]
    return idx.to(torch.int32)


def _partition(a, kth, axis=-1, kind="introselect", order=None):
    # jax's arrangement: the kth + 1 smallest, ascending, then the rest,
    # descending (two top-k selections)
    x = torch.movedim(_T(a), axis, -1)
    n = x.shape[-1]
    kth = kth % n
    lo = -torch.topk(-x, kth + 1, dim=-1).values
    hi = torch.topk(x, n - kth - 1, dim=-1).values
    return torch.movedim(torch.cat([lo, hi], dim=-1), -1, axis)


def _argpartition(a, kth, axis=-1, kind="introselect", order=None):
    # the kth + 1 smallest, then the other indices ascending (jax's)
    x = torch.movedim(_T(a), axis, -1)
    n = x.shape[-1]
    kth = kth % n
    lo = torch.topk(-x, kth + 1, dim=-1).indices
    rest = torch.ones(x.shape, device=x.device).scatter(-1, lo, 0.0)
    hi = torch.sort(rest, dim=-1, descending=True,
                    stable=True).indices[..., :n - kth - 1]
    return torch.movedim(torch.cat([lo, hi], dim=-1), -1,
                         axis).to(torch.int32)


for _n, _tf in [("sort", _sort), ("argsort", _argsort),
                ("lexsort", _lexsort), ("partition", _partition),
                ("argpartition", _argpartition)]:
    _def(_n, _tf)


# ---------------------------------------------------------------- sets

def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, equal_nan=True, **kw):
    x = _T(ar)
    if axis is None:
        x = x.reshape(-1)
        dim = 0
    else:
        dim = axis
    u, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                               return_counts=True, dim=dim if axis is not
                               None else None)
    out = [u]
    if return_index:
        n = x.shape[dim]
        first = torch.full((u.shape[dim],), n, dtype=torch.int64,
                           device=x.device)
        first = first.scatter_reduce(0, inv.reshape(-1),
                                     torch.arange(n, device=x.device),
                                     reduce="amin")
        out.append(first.to(torch.int32))
    if return_inverse:
        out.append(inv.to(torch.int32))
    if return_counts:
        out.append(cnt.to(torch.int32))
    return out[0] if len(out) == 1 else tuple(out)


def _u(x):
    return torch.unique(_T(x).reshape(-1), sorted=True)


def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    a = _u(ar1)
    return a[torch.isin(a, _T(ar2, a))]


def _setdiff1d(ar1, ar2, assume_unique=False):
    a = _u(ar1)
    return a[~torch.isin(a, _T(ar2, a))]


def _setxor1d(ar1, ar2, assume_unique=False):
    a, b = _u(ar1), _u(ar2)
    both = torch.cat([a, b.to(a.dtype)])
    vals, counts = torch.unique(both, sorted=True, return_counts=True)
    return vals[counts == 1]


def _isin(element, test_elements, assume_unique=False, invert=False,
          **kw):
    x = _T(element)
    r = torch.isin(x, _T(test_elements, x))
    return ~r if invert else r


for _n, _tf in [
        ("unique", _unique), ("intersect1d", _intersect1d),
        ("union1d", lambda ar1, ar2: torch.unique(torch.cat([
            _T(ar1).reshape(-1), _T(ar2).reshape(-1)]), sorted=True)),
        ("setdiff1d", _setdiff1d), ("setxor1d", _setxor1d),
        ("in1d", lambda ar1, ar2, assume_unique=False, invert=False:
         _isin(_T(ar1).reshape(-1), ar2, invert=invert)),
        ("isin", _isin)]:
    _def(_n, _tf)


# ------------------------------------------------- statistics / misc

def _bincount(x, weights=None, minlength=0, *, length=None):
    x = _T(x).to(torch.int64)
    n = _builtins.max(int(minlength or 0), int(length or 0))
    if weights is None:
        return torch.bincount(x, minlength=n).to(torch.int32)
    w = _T(weights, x)
    return torch.bincount(x, weights=w, minlength=n).to(
        _fl(w).dtype)


def _digitize(x, bins, right=False):
    x = _T(x)
    b = _T(bins, x)
    dt = torch.promote_types(x.dtype, b.dtype)
    return torch.searchsorted(b.to(dt), x.to(dt),
                              right=not right).to(torch.int32)


def _edges(x, bins, rng):
    if isinstance(bins, torch.Tensor) or not isinstance(bins, int):
        return _T(bins, x).to(x.dtype)
    if rng is None:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.tensor(float(rng[0]), dtype=x.dtype, device=x.device)
        hi = torch.tensor(float(rng[1]), dtype=x.dtype, device=x.device)
    same = lo == hi
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    # jax's linspace: lo (1 - t) + hi t at t = i / bins, then hi itself
    t = torch.arange(bins, device=x.device, dtype=x.dtype) / bins
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def _bin_of(x, edges):
    """The bin of each value (numpy's rule: the last bin holds its right
    edge), and whether it falls in a bin."""
    nb = edges.numel() - 1
    idx = torch.searchsorted(edges, x.contiguous(), right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, nb - 1), idx)
    ok = (idx >= 0) & (idx < nb)
    return idx.clamp(0, nb - 1), ok


def _histogramdd(sample, bins=10, range=None, weights=None, density=None):
    s = _fl(_T(sample))
    if s.dim() == 1:
        s = s[:, None]
    d = s.shape[1]
    bins_ = bins if isinstance(bins, (list, tuple)) else [bins] * d
    rng = range if range is not None else [None] * d
    edges = [_edges(s[:, k], bins_[k], rng[k]) for k in _builtins.range(d)]
    flat = torch.zeros(s.shape[0], dtype=torch.int64, device=s.device)
    ok = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    shape = []
    for k, e_ in enumerate(edges):
        i, v = _bin_of(s[:, k], e_)
        flat = flat * (e_.numel() - 1) + i
        ok = ok & v
        shape.append(e_.numel() - 1)
    w = None if weights is None else _T(weights, s).to(s.dtype)
    counts = w is None and not density
    w = ok.to(s.dtype) if w is None else w * ok
    n = int(_onp.prod(shape))
    h = torch.zeros(n, dtype=s.dtype, device=s.device).index_add_(
        0, flat, w).reshape(shape)
    if density:
        widths = [torch.diff(e_) for e_ in edges]
        vol = widths[0]
        for wd in widths[1:]:
            vol = vol[..., None] * wd
        h = h / h.sum() / vol
    # plain counts in int32, and edges of one length as one array, as
    # the reference's histogramdd gives them
    if counts:
        h = h.round().to(torch.int32)
    return h, edges


def _histogramdd_op(sample, bins=10, range=None, weights=None,
                    density=None):
    h, edges = _histogramdd(sample, bins, range, weights, density)
    if len({e_.numel() for e_ in edges}) == 1:
        return h, torch.stack(edges)
    return h, edges


def _histogram(a, bins=10, range=None, weights=None, density=None):
    h, edges = _histogramdd(_T(a).reshape(-1), [bins],
                            None if range is None else [range], weights,
                            density)
    return _fl(h), edges[0]


def _histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    x = _T(x)
    h, edges = _histogramdd(torch.stack([_fl(x), _fl(_T(y, x))], 1), bins,
                            range, weights, density)
    return h, edges[0], edges[1]


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None, dtype=None):
    x = _fl(_T(m))
    if x.dim() == 1:
        x = x[None]
    if not rowvar:
        x = x.t()
    if y is not None:
        yy = _fl(_T(y, x))
        yy = yy[None] if yy.dim() == 1 else yy
        x = torch.cat([x, yy if rowvar else yy.t()], 0)
    corr = ddof if ddof is not None else (0 if bias else 1)
    return torch.cov(x, correction=corr).squeeze()


def _corrcoef(x, y=None, rowvar=True, dtype=None):
    c = _cov(x, y, rowvar)
    d = torch.sqrt(torch.diagonal(c))
    return (c / d[:, None] / d[None, :]).clamp(-1, 1)


def _convolve(a, v, mode="full", flip=True):
    a, v = _fl(_T(a)), _fl(_T(v, _T(a)))
    dt = torch.promote_types(a.dtype, v.dtype)
    a, v = a.to(dt), v.to(dt)
    if a.numel() < v.numel():
        a, v = v, a
    n, m = a.numel(), v.numel()
    k = v.flip(0) if flip else v
    full = _F.conv1d(a.reshape(1, 1, n), k.reshape(1, 1, m),
                     padding=m - 1).reshape(-1)
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    if mode == "valid":
        return full[m - 1:n]
    raise ValueError(f"mode {mode!r}")


def _correlate(a, v, mode="valid", **kw):
    a, v = _T(a), _T(v, _T(a))
    if a.numel() < v.numel():
        return _correlate(v, a, mode).flip(0)
    return _convolve(a, v, mode, flip=False)


def _interp(x, xp, fp, left=None, right=None, period=None):
    x = _fl(_T(x))
    xp = _T(xp, x).to(x.dtype)
    fp = _T(fp, x).to(x.dtype)
    n = xp.numel()
    j = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    x0, x1 = xp[j - 1], xp[j]
    y0, y1 = fp[j - 1], fp[j]
    t = (x - x0) / (x1 - x0)
    y = y0 + t * (y1 - y0)
    y = torch.where(x < xp[0], torch.full_like(y, fp[0].item() if left is
                                               None else left), y)
    y = torch.where(x > xp[-1], torch.full_like(y, fp[-1].item() if right
                                                is None else right), y)
    return torch.where(x == xp[-1], fp[-1].expand_as(y), y)


def _gradient(f, *varargs, axis=None, edge_order=1):
    x = _fl(_T(f))
    axes = _axes(axis, x.dim())
    out = []
    for k, ax in enumerate(axes):
        h = float(varargs[k if len(varargs) > 1 else 0]) if varargs \
            else 1.0
        n = x.shape[ax]
        mid = (x.narrow(ax, 2, n - 2) - x.narrow(ax, 0, n - 2)) / (2 * h)
        first = (x.narrow(ax, 1, 1) - x.narrow(ax, 0, 1)) / h
        last = (x.narrow(ax, n - 1, 1) - x.narrow(ax, n - 2, 1)) / h
        out.append(torch.cat([first, mid, last], dim=ax))
    return out[0] if len(out) == 1 else out


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    x = _T(a)
    pre = None if prepend is None else _T(prepend, x)
    app = None if append is None else _T(append, x)
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)


def _ediff1d(ary, to_end=None, to_begin=None):
    x = _T(ary).reshape(-1)
    parts = [torch.diff(x)]
    if to_begin is not None:
        parts.insert(0, _T(to_begin, x).reshape(-1).to(x.dtype))
    if to_end is not None:
        parts.append(_T(to_end, x).reshape(-1).to(x.dtype))
    return torch.cat(parts)


def _polyval(p, x):
    p = _T(p)
    x = _T(x, p)
    y = torch.zeros_like(_fl(x)) if p.numel() == 0 else \
        torch.zeros_like(x.to(torch.promote_types(p.dtype, x.dtype)))
    for c in p.reshape(-1).unbind(0):
        y = y * x + c
    return y


def _vander(x, N=None, increasing=False):
    x = _T(x)
    n = x.numel() if N is None else N
    pw = torch.arange(n, device=x.device)
    if not increasing:
        pw = pw.flip(0)
    return x.reshape(-1, 1) ** pw.to(x.dtype if x.is_floating_point()
                                     else torch.int32)


def _polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    x = _fl(_T(x))
    y = _T(y, x).to(x.dtype)
    v = _vander(x, deg + 1)
    if w is not None:
        ww = _T(w, x).to(x.dtype)
        v, y = v * ww[:, None], y * (ww if y.dim() == 1 else ww[:, None])
    # scale the columns, as numpy's polyfit does, for the conditioning
    scale = torch.sqrt((v * v).sum(0))
    sol = torch.linalg.pinv(v / scale) @ y
    return sol / (scale if sol.dim() == 1 else scale[:, None])


def _trim_zeros(filt, trim="fb"):
    x = _T(filt)
    nz = torch.nonzero(x.reshape(-1)).reshape(-1)
    if nz.numel() == 0:
        return x[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else x.numel()
    return x[lo:hi]


def _block(arrays):
    def depth(a):
        return 1 + depth(a[0]) if isinstance(a, list) else 0

    def maxnd(a):
        return _builtins.max(maxnd(v) for v in a) if isinstance(a, list) else \
            _T(a).dim()

    d = depth(arrays)
    nd = _builtins.max(maxnd(arrays), d)

    def rec(a, level):
        if not isinstance(a, list):
            t = _T(a)
            while t.dim() < nd:
                t = t.unsqueeze(0)
            return t
        return _concatenate([rec(v, level + 1) for v in a],
                            axis=-(d - level))

    return rec(arrays, 0)


for _n, _tf in [
        ("bincount", _bincount), ("digitize", _digitize),
        ("histogram", _histogram), ("histogram2d", _histogram2d),
        ("histogramdd", _histogramdd_op), ("corrcoef", _corrcoef),
        ("cov", _cov), ("convolve", _convolve), ("correlate", _correlate),
        ("interp", _interp), ("gradient", _gradient), ("diff", _diff),
        ("ediff1d", _ediff1d), ("polyval", _polyval), ("polyfit", _polyfit),
        ("vander", _vander), ("trim_zeros", _trim_zeros),
        ("block", _block)]:
    _def(_n, _tf)

# legacy-name aliases
trapz = globals()["trapezoid"]
round_ = globals()["round"]
fix = _wrap("fix", _first(lambda x: x if not x.is_floating_point()
                          else x.trunc()), differentiable=False)
__all__ += ["trapz", "round_"]


# ------------------------------------------- host-side type utilities

def _np_dtype_of(x):
    if isinstance(x, NDArray):
        return _onp.dtype(x.dtype)
    if isinstance(x, torch.dtype):
        return _host_dtype(x)
    return x


def result_type(*arrays_and_dtypes):
    """The dtype an op over these arrays and dtypes gives (host)."""
    return _onp.result_type(*[_np_dtype_of(x) for x in arrays_and_dtypes])


def promote_types(a, b):
    return _onp.promote_types(_np_dtype_of(a), _np_dtype_of(b))


def can_cast(from_, to, casting="safe"):
    return _onp.can_cast(_np_dtype_of(from_), _np_dtype_of(to), casting)


def iinfo(int_type):
    return _onp.iinfo(_np_dtype_of(int_type))


def finfo(dtype):
    return _onp.finfo(_np_dtype_of(dtype))


def isscalar(element):
    return _onp.isscalar(element)


def ndim(a):
    return a.ndim if isinstance(a, NDArray) else _onp.ndim(a)


def shape(a):
    return a.shape if isinstance(a, NDArray) else _onp.shape(a)


def size(a, axis=None):
    if isinstance(a, NDArray):
        return a.size if axis is None else a.shape[axis]
    return _onp.size(a, axis)


def may_share_memory(a, b, max_work=None):
    return False


def shares_memory(a, b, max_work=None):
    return False


__all__ += ["result_type", "promote_types", "can_cast", "iinfo", "finfo",
            "isscalar", "ndim", "shape", "size"]

# the reference's shadowing of builtins, kept
abs = globals()["abs"]  # noqa: A001
round = globals()["round"]  # noqa: A001
min = globals()["min"]  # noqa: A001
max = globals()["max"]  # noqa: A001
sum = globals()["sum"]  # noqa: A001
all = globals()["all"]  # noqa: A001
any = globals()["any"]  # noqa: A001


# ----------------------------------------------------------- creation

def _shape_of(s):
    return (int(s),) if isinstance(s, (int, _onp.integer)) else \
        tuple(int(v) for v in s)


def _creation(name):
    def deco(fn):
        def op(*args, ctx=None, device=None, **kwargs):
            with _on(ctx or device):
                res = fn(*args, **kwargs)
            if isinstance(res, (tuple, list)):
                return [NDArray(_narrow(r)) for r in res]
            return NDArray(_narrow(res))
        op.__name__ = op.__qualname__ = name
        op.__doc__ = fn.__doc__
        __all__.append(name)
        globals()[name] = op
        return op
    return deco


class _on:
    """Scope for a creation function's ``ctx``/``device`` argument."""

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        if self.ctx is not None:
            from ..context import Context
            c = self.ctx if isinstance(self.ctx, Context) else \
                Context(_resolve_device(self.ctx))
            self._scope = c
            c.__enter__()
        return self

    def __exit__(self, *a):
        if self.ctx is not None:
            self._scope.__exit__(*a)
        return False


def _fdt(dtype, default=torch.float32):
    return default if dtype is None else _tdtype(dtype)


def _value_dtype(v, dtype):
    if dtype is not None:
        return _tdtype(dtype)
    if isinstance(v, NDArray):
        return v._t.dtype
    a = _onp.asarray(v)
    if a.dtype == _onp.bool_:
        return torch.bool
    return torch.int32 if a.dtype.kind in "iu" else torch.float32


@_creation("zeros")
def _zeros(shape, dtype=None, order="C"):
    return torch.zeros(_shape_of(shape), dtype=_fdt(dtype), device=_device())


@_creation("ones")
def _ones(shape, dtype=None, order="C"):
    return torch.ones(_shape_of(shape), dtype=_fdt(dtype), device=_device())


@_creation("full")
def _full(shape, fill_value, dtype=None, order="C"):
    dt = _value_dtype(fill_value, dtype)
    if isinstance(fill_value, NDArray):
        return torch.broadcast_to(fill_value._t.to(dt),
                                  _shape_of(shape)).clone()
    return torch.full(_shape_of(shape), fill_value, dtype=dt,
                      device=_device())


@_creation("empty")
def _empty(shape, dtype=None, order="C"):
    return torch.zeros(_shape_of(shape), dtype=_fdt(dtype), device=_device())


@_creation("arange")
def _arange(start, stop=None, step=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    step = 1 if step is None else step
    ints = _builtins.all(isinstance(v, (int, _onp.integer))
               for v in (start, stop, step))
    dt = _fdt(dtype, torch.int32 if ints else torch.float32)
    if ints:
        return torch.arange(start, stop, step, device=_device()).to(dt)
    return torch.arange(start, stop, step, dtype=torch.float64,
                        device=_device()).to(dt)


@_creation("linspace")
def _linspace(start, stop, num=50, endpoint=True, retstep=False,
              dtype=None, axis=0):
    dev = _device()
    n = num if endpoint else num + 1
    r = torch.linspace(float(start), float(stop), n, dtype=torch.float64,
                       device=dev)
    if not endpoint:
        r = r[:-1]
    r = r.to(_fdt(dtype))
    if retstep:
        div = (num - 1) if endpoint else num
        step = (float(stop) - float(start)) / _builtins.max(div, 1)
        return r, torch.tensor(step, dtype=torch.float32, device=dev)
    return r


@_creation("logspace")
def _logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
              axis=0):
    n = num if endpoint else num + 1
    r = torch.linspace(float(start), float(stop), n, dtype=torch.float64,
                       device=_device())
    if not endpoint:
        r = r[:-1]
    return torch.pow(float(base), r).to(_fdt(dtype))


@_creation("geomspace")
def _geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0):
    sign = -1.0 if float(start) < 0 else 1.0
    n = num if endpoint else num + 1
    r = torch.linspace(_math.log10(_builtins.abs(float(start))),
                       _math.log10(_builtins.abs(float(stop))), n,
                       dtype=torch.float64, device=_device())
    if not endpoint:
        r = r[:-1]
    out = sign * torch.pow(10.0, r)
    out[0] = float(start)
    if endpoint and num > 1:
        out[-1] = float(stop)
    return out.to(_fdt(dtype))


@_creation("eye")
def _eye(N, M=None, k=0, dtype=None, order="C"):
    dev = _device()
    m = N if M is None else M
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    return (j - i == k).to(_fdt(dtype))


@_creation("identity")
def _identity(n, dtype=None):
    return torch.eye(n, dtype=_fdt(dtype), device=_device())


@_creation("tri")
def _tri(N, M=None, k=0, dtype=None):
    dev = _device()
    m = N if M is None else M
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    return (j - i <= k).to(_fdt(dtype))


def _like_dt(a, dtype):
    t = a._t if isinstance(a, NDArray) else _T(a)
    return t, (t.dtype if dtype is None else _tdtype(dtype))


@_creation("zeros_like")
def _zeros_like(a, dtype=None, shape=None):
    t, dt = _like_dt(a, dtype)
    return torch.zeros(t.shape if shape is None else _shape_of(shape),
                       dtype=dt, device=t.device)


@_creation("ones_like")
def _ones_like(a, dtype=None, shape=None):
    t, dt = _like_dt(a, dtype)
    return torch.ones(t.shape if shape is None else _shape_of(shape),
                      dtype=dt, device=t.device)


@_creation("full_like")
def _full_like(a, fill_value, dtype=None, shape=None):
    t, dt = _like_dt(a, dtype)
    return torch.full(t.shape if shape is None else _shape_of(shape),
                      fill_value, dtype=dt, device=t.device)


@_creation("empty_like")
def _empty_like(prototype, dtype=None, shape=None):
    t, dt = _like_dt(prototype, dtype)
    return torch.zeros(t.shape if shape is None else _shape_of(shape),
                       dtype=dt, device=t.device)


@_creation("meshgrid")
def _meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    ts = [_T(x).reshape(-1) for x in xi]
    grids = torch.meshgrid(*ts, indexing=indexing)
    if sparse:
        n = len(ts)
        out = []
        for k, t in enumerate(ts):
            shape = [1] * n
            shape[k] = t.numel()
            if indexing == "xy" and n > 1:
                shape[0], shape[1] = shape[1], shape[0]
            out.append(t.reshape(shape))
        return out
    return [g.clone() for g in grids]


@_creation("fromfunction")
def _fromfunction(function, shape, dtype=float, **kwargs):
    dev = _device()
    dt = _fdt(None if dtype is float else dtype)
    grids = torch.meshgrid(*[torch.arange(s, device=dev, dtype=dt)
                             for s in _shape_of(shape)], indexing="ij")
    res = function(*[NDArray(g) for g in grids], **kwargs)
    return res._t if isinstance(res, NDArray) else _T(res)


@_creation("frombuffer")
def _frombuffer(buffer, dtype=float, count=-1, offset=0):
    a = _onp.frombuffer(buffer, dtype=dtype, count=count, offset=offset)
    return _T(a.copy())


@_creation("copy")
def _copy(a, order="K", subok=False):
    return _T(a).detach().clone() if isinstance(a, NDArray) else _T(a)


@_creation("asarray")
def _asarray(a, dtype=None, order=None, copy=None):
    t = _T(a)
    return t if dtype is None else t.to(_tdtype(dtype))


def array(obj, dtype=None, ctx=None, device=None, copy=True):
    """An array of ``obj`` (parity: mx.np.array; ``ctx``/``device``
    accepted); numpy's dtype rules in jax's 32-bit family."""
    with _on(ctx or device):
        if isinstance(obj, NDArray):
            t = obj._t.detach().to(_device()).clone()
        else:
            t = _T(obj)
            if isinstance(obj, (list, tuple)) and not _builtins.any(
                    isinstance(v, (NDArray, torch.Tensor))
                    for v in _flat(obj)):
                t = t.clone()
    return NDArray(t if dtype is None else t.to(_tdtype(dtype)))


__all__.append("array")


# ----------------------------------------------- callable-taking functions
# the user's function gets NDArrays and may return them, so code written
# against the mx.np surface runs inside (and autograd records it)

def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    a = arr if isinstance(arr, NDArray) else array(arr)
    moved = globals()["moveaxis"](a, axis, -1)
    lead = moved.shape[:-1]
    flat = globals()["reshape"](moved, (-1, moved.shape[-1]))
    rows = [func1d(flat[i], *args, **kwargs) for i in range(flat.shape[0])]
    rows = [r if isinstance(r, NDArray) else array(r) for r in rows]
    out = globals()["stack"](rows)
    return globals()["reshape"](out, lead + tuple(out.shape[1:]))


def apply_over_axes(func, a, axes):
    val = a if isinstance(a, NDArray) else array(a)
    for ax in _seq(axes):
        res = func(val, ax)
        if res.ndim == val.ndim - 1:
            res = globals()["expand_dims"](res, ax)
        val = res
    return val


__all__ += ["apply_along_axis", "apply_over_axes"]


# ------------------------------------------------------------- submodules

from . import linalg  # noqa: E402
from . import random  # noqa: E402

__all__ += ["linalg", "random"]
