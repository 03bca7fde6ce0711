"""The ``nd`` operator namespace (counterpart of
``mxnet_tpu/ndarray/ops.py``).

Each op is a plain torch function over the tensors behind its NDArray
inputs, dispatched by :func:`invoke`, which runs it under
``torch.set_grad_enabled(is_recording())`` so a graph is built only
inside ``autograd.record()``, exactly where the reference's tape records.
Names and signatures are the reference's, every one of them: the random
samplers live in :mod:`.sampling` and the spatial, ROI and detection ops
in :mod:`.detection`, both re-exported here.
"""
from __future__ import annotations

import builtins
import math
import numbers
from typing import Tuple

import torch
import torch.nn.functional as Fn

from .. import amp as _amp
from .. import base as _base
from .. import random as _random
from ..base import torch_dtype
from .ndarray import NDArray, array

__all__: list = []  # populated by _export

# the reference's ops the port lacks: none since the sampling, linalg,
# detection and index ops; kept (empty) so that a test can hold it so
NOT_YET_PORTED = frozenset()


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _alias(name, fn):
    globals()[name] = fn
    __all__.append(name)


# ---------------------------------------------------------------- dispatcher

def _whole(tensors):
    """``tensors`` with every vocabulary block (a tied head's logits under
    ``tp``, ``sharding.vocab_block``) gathered whole over ``tp``: an op
    never computes on a rank's block as if it were the whole array."""
    if not any(getattr(t, "_mxt_sharding", None) is not None
               for t in tensors):
        return tensors
    from ..parallel.sharding import gather_vocab
    return [gather_vocab(t) if isinstance(t, torch.Tensor) else t
            for t in tensors]


# observers of every dispatched op: ``hook(name, outputs)`` after each
# op (``mx.monitor.Monitor`` installs one)
_invoke_hooks = []


def invoke(name, fn, nd_inputs, nout=1, ctx=None, differentiable=True,
           vocab_blocks=False):
    """Run ``fn`` over the tensors of ``nd_inputs`` and wrap what it
    returns (a tensor, or a tuple/list of them) as NDArrays; a graph is
    built only while recording and only for a differentiable op.  Under
    ``amp.init()`` the inputs are first cast as the policy casts op
    ``name``'s.  A vocabulary block among the inputs is gathered whole
    first (:func:`_whole`) unless ``vocab_blocks`` says ``fn`` takes
    blocks (the vocab-parallel losses).  Each hook of
    ``_invoke_hooks`` then sees ``(name, outputs)``."""
    with torch.set_grad_enabled(_base.is_recording() and differentiable):
        ts = [x._t for x in nd_inputs]
        out = fn(*_amp.cast(name, *(ts if vocab_blocks else _whole(ts))))
    if isinstance(out, (tuple, list)):
        res = [NDArray(o) for o in out]
    else:
        res = NDArray(out)
    if _invoke_hooks:
        seen = res if isinstance(res, list) else [res]
        for h in tuple(_invoke_hooks):
            h(name, seen)
    return res


def _as_nd(x, like=None):
    """``x`` as an NDArray, on ``like``'s device when given."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor):
        return NDArray(x if like is None else x.to(like._t.device))
    return array(x, ctx=None if like is None else like._t.device)


def _first_nd(*xs):
    return next((x for x in xs if isinstance(x, NDArray)), None)


def apply_op(name, fn, inputs, vocab_blocks=False):
    """Op ``name`` as either convention calls it: with an NDArray among
    ``inputs``, through :func:`invoke` (a graph only inside
    ``autograd.record()``, NDArrays out); with tensors, ``fn`` on them as
    the amp policy casts op ``name``'s inputs, in the caller's grad
    mode.  Vocabulary blocks are gathered whole unless ``vocab_blocks``
    (as :func:`invoke`)."""
    like = _first_nd(*inputs)
    if like is not None:
        return invoke(name, fn, [_as_nd(x, like) for x in inputs],
                      vocab_blocks=vocab_blocks)
    if not vocab_blocks:
        inputs = _whole(inputs)
    return fn(*_amp.cast(name, *inputs))


def _scalar(s, t):
    """A Python number as a 0-d CPU tensor of its promoted dtype with
    ``t`` (torch mixes such scalars with tensors on any device)."""
    s = s.item() if hasattr(s, "item") else s
    return torch.tensor(s, dtype=torch.result_type(t, s))


def _unary_op(name, tfn, differentiable=True):
    def op(data, out=None, **ignored):
        r = invoke(name, tfn, [_as_nd(data)], differentiable=differentiable)
        return _into(out, r)
    op.__name__ = name
    return _export(op)


def _into(out, r):
    if out is None:
        return r
    with torch.no_grad():
        out._t.copy_(r._t)
    return out


def _binary_op(name, tfn, differentiable=True):
    """``tfn(a, b)`` over two tensors; a Python number on either side
    becomes a 0-d tensor of the promoted dtype."""
    def op(lhs, rhs, out=None, **ignored):
        like = _first_nd(lhs, rhs)
        if like is None:
            return tfn(torch.as_tensor(lhs), torch.as_tensor(rhs)).item()
        if isinstance(lhs, numbers.Number):
            r = invoke(name, lambda b: tfn(_scalar(lhs, b), b), [rhs],
                       differentiable=differentiable)
        elif isinstance(rhs, numbers.Number):
            r = invoke(name, lambda a: tfn(a, _scalar(rhs, a)), [lhs],
                       differentiable=differentiable)
        else:
            r = invoke(name, tfn, [_as_nd(lhs, like), _as_nd(rhs, like)],
                       differentiable=differentiable)
        return _into(out, r)
    op.__name__ = name
    return _export(op)


def _cmp(tfn):
    # MXNet comparisons give 0/1 in the left operand's dtype
    return lambda a, b: tfn(a, b).to(a.dtype)


def _logical(tfn):
    return lambda a, b: tfn(a.bool(), b.bool()).to(torch.float32)


# ------------------------------------------------------------- element-wise

add = _binary_op("add", torch.add)
subtract = _binary_op("subtract", torch.sub)
multiply = _binary_op("multiply", torch.mul)
divide = _binary_op("divide", torch.true_divide)
floor_divide = _binary_op("floor_divide", torch.floor_divide,
                          differentiable=False)
mod = _binary_op("mod", torch.remainder)
power = _binary_op("power", torch.pow)
maximum = _binary_op("maximum", torch.maximum)
minimum = _binary_op("minimum", torch.minimum)
hypot = _binary_op("hypot", torch.hypot)
arctan2 = _binary_op("arctan2", torch.atan2)
equal = _binary_op("equal", _cmp(torch.eq), differentiable=False)
not_equal = _binary_op("not_equal", _cmp(torch.ne), differentiable=False)
greater = _binary_op("greater", _cmp(torch.gt), differentiable=False)
greater_equal = _binary_op("greater_equal", _cmp(torch.ge),
                           differentiable=False)
lesser = _binary_op("lesser", _cmp(torch.lt), differentiable=False)
lesser_equal = _binary_op("lesser_equal", _cmp(torch.le),
                          differentiable=False)
logical_and = _binary_op("logical_and", _logical(torch.logical_and),
                         differentiable=False)
logical_or = _binary_op("logical_or", _logical(torch.logical_or),
                        differentiable=False)
logical_xor = _binary_op("logical_xor", _logical(torch.logical_xor),
                         differentiable=False)

# broadcast_* / elemwise_* names (MXNet's)
for _nm, _f in [("broadcast_add", "add"), ("broadcast_sub", "subtract"),
                ("broadcast_mul", "multiply"), ("broadcast_div", "divide"),
                ("broadcast_power", "power"), ("broadcast_maximum", "maximum"),
                ("broadcast_minimum", "minimum"), ("broadcast_mod", "mod"),
                ("broadcast_equal", "equal"),
                ("broadcast_not_equal", "not_equal"),
                ("broadcast_greater", "greater"),
                ("broadcast_greater_equal", "greater_equal"),
                ("broadcast_lesser", "lesser"),
                ("broadcast_lesser_equal", "lesser_equal"),
                ("broadcast_logical_and", "logical_and"),
                ("broadcast_logical_or", "logical_or"),
                ("broadcast_logical_xor", "logical_xor"),
                ("elemwise_add", "add"), ("elemwise_sub", "subtract"),
                ("elemwise_mul", "multiply"), ("elemwise_div", "divide")]:
    _alias(_nm, globals()[_f])


def _f32(tfn):
    """``tfn`` on a float tensor (integers promote to float32, as jnp's
    transcendental functions do)."""
    return lambda x: tfn(x if x.is_floating_point() else x.float())


def _flag(tfn):
    return lambda x: tfn(x).to(torch.float32)


negative = _unary_op("negative", torch.neg)
abs = _unary_op("abs", torch.abs)
sign = _unary_op("sign", torch.sign, differentiable=False)
round = _unary_op("round", torch.round, differentiable=False)
rint = _unary_op("rint", torch.round, differentiable=False)
floor = _unary_op("floor", torch.floor, differentiable=False)
ceil = _unary_op("ceil", torch.ceil, differentiable=False)
trunc = _unary_op("trunc", torch.trunc, differentiable=False)
fix = _unary_op("fix", torch.trunc, differentiable=False)
exp = _unary_op("exp", _f32(torch.exp))
expm1 = _unary_op("expm1", _f32(torch.expm1))
log = _unary_op("log", _f32(torch.log))
log10 = _unary_op("log10", _f32(torch.log10))
log2 = _unary_op("log2", _f32(torch.log2))
log1p = _unary_op("log1p", _f32(torch.log1p))
sqrt = _unary_op("sqrt", _f32(torch.sqrt))
rsqrt = _unary_op("rsqrt", _f32(torch.rsqrt))
cbrt = _unary_op("cbrt", _f32(lambda x: torch.sign(x) *
                               torch.abs(x) ** (1.0 / 3.0)))
rcbrt = _unary_op("rcbrt", _f32(lambda x: 1.0 / (torch.sign(x) *
                                                 torch.abs(x) ** (1 / 3.0))))
square = _unary_op("square", torch.square)
reciprocal = _unary_op("reciprocal", _f32(torch.reciprocal))
sin = _unary_op("sin", _f32(torch.sin))
cos = _unary_op("cos", _f32(torch.cos))
tan = _unary_op("tan", _f32(torch.tan))
arcsin = _unary_op("arcsin", _f32(torch.asin))
arccos = _unary_op("arccos", _f32(torch.acos))
arctan = _unary_op("arctan", _f32(torch.atan))
sinh = _unary_op("sinh", _f32(torch.sinh))
cosh = _unary_op("cosh", _f32(torch.cosh))
tanh = _unary_op("tanh", _f32(torch.tanh))
arcsinh = _unary_op("arcsinh", _f32(torch.asinh))
arccosh = _unary_op("arccosh", _f32(torch.acosh))
arctanh = _unary_op("arctanh", _f32(torch.atanh))
degrees = _unary_op("degrees", _f32(torch.rad2deg))
radians = _unary_op("radians", _f32(torch.deg2rad))
erf = _unary_op("erf", _f32(torch.erf))
erfinv = _unary_op("erfinv", _f32(torch.erfinv))
gamma = _unary_op("gamma", _f32(lambda x: torch.exp(torch.lgamma(x))))
gammaln = _unary_op("gammaln", _f32(torch.lgamma))
sigmoid = _unary_op("sigmoid", _f32(torch.sigmoid))
softsign = _unary_op("softsign", _f32(Fn.softsign))
relu = _unary_op("relu", torch.relu)
softplus = _unary_op("softplus", _f32(Fn.softplus))
logical_not = _unary_op("logical_not", _flag(torch.logical_not),
                        differentiable=False)
isnan = _unary_op("isnan", _flag(torch.isnan), differentiable=False)
isinf = _unary_op("isinf", _flag(torch.isinf), differentiable=False)
isfinite = _unary_op("isfinite", _flag(torch.isfinite), differentiable=False)
zeros_like = _unary_op("zeros_like", torch.zeros_like, differentiable=False)
ones_like = _unary_op("ones_like", torch.ones_like, differentiable=False)
identity = _unary_op("identity", lambda x: x.view_as(x))


@_export
def clip(data, a_min=None, a_max=None, out=None, **kw):
    return _into(out, invoke("clip", lambda x: torch.clamp(x, a_min, a_max),
                             [_as_nd(data)]))


@_export
def cast(data, dtype, out=None):
    dt = torch_dtype(dtype)
    return _into(out, invoke("cast", lambda x: x.to(dt), [_as_nd(data)]))


_alias("Cast", cast)


@_export
def where(condition, x, y):
    like = _first_nd(condition, x, y)
    c, a, b = (_as_nd(v, like) for v in (condition, x, y))
    return invoke("where", lambda c_, a_, b_: torch.where(c_.bool(), a_, b_),
                  [c, a, b])


# ---------------------------------------------------------------- reductions

def _axes(ndim, axis, exclude=False) -> Tuple[int, ...]:
    """The reduced axes: all for None / (), else ``axis`` (or, with
    ``exclude``, every other axis, which may be none)."""
    if axis is None or (isinstance(axis, (list, tuple)) and not axis):
        return tuple(range(ndim))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % ndim for a in ax)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce_op(name, tfn, differentiable=True):
    def op(data, axis=None, keepdims=False, exclude=False, out=None, **kw):
        data = _as_nd(data)
        ax = _axes(data.ndim, axis, exclude)

        def f(x):
            if not ax:           # nothing to reduce (the jnp semantics)
                return x
            return tfn(x, dim=ax, keepdim=keepdims)
        return _into(out, invoke(name, f, [data],
                                 differentiable=differentiable))
    op.__name__ = name
    return _export(op)


sum = _reduce_op("sum", torch.sum)
mean = _reduce_op("mean", lambda x, dim, keepdim: torch.mean(
    x if x.is_floating_point() else x.float(), dim=dim, keepdim=keepdim))
prod = _reduce_op("prod", _prod)
max = _reduce_op("max", torch.amax)
min = _reduce_op("min", torch.amin)
nansum = _reduce_op("nansum", torch.nansum)
nanprod = _reduce_op("nanprod", lambda x, dim, keepdim: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim))
_alias("sum_axis", sum)


@_export
def norm(data, ord=2, axis=None, keepdims=False, out=None):
    data = _as_nd(data)
    ax = _axes(data.ndim, axis)
    if ord not in (1, 2):
        raise ValueError("norm only supports ord=1,2")

    def f(x):
        if ord == 2:
            return torch.sqrt(torch.sum(torch.square(x), dim=ax,
                                        keepdim=keepdims))
        return torch.sum(torch.abs(x), dim=ax, keepdim=keepdims)
    return invoke("norm", f, [data])


def _arg(tfn):
    def f(x, axis, keepdims):
        if axis is None:
            r = tfn(x.reshape(-1), dim=0)
            if keepdims:
                r = r.reshape((1,) * x.dim())
        else:
            r = tfn(x, dim=axis, keepdim=keepdims)
        return r.to(torch.float32)
    return f


@_export
def argmax(data, axis=None, keepdims=False):
    return invoke("argmax", lambda x: _arg(torch.argmax)(x, axis, keepdims),
                  [_as_nd(data)], differentiable=False)


@_export
def argmin(data, axis=None, keepdims=False):
    return invoke("argmin", lambda x: _arg(torch.argmin)(x, axis, keepdims),
                  [_as_nd(data)], differentiable=False)


@_export
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    dt = torch_dtype(dtype)

    def f(x):
        vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend)
        if ret_typ == "indices":
            return idx.to(dt)
        if ret_typ == "value":
            return vals
        return (vals, idx.to(dt))
    return invoke("topk", f, [_as_nd(data)], differentiable=False)


@_export
def sort(data, axis=-1, is_ascend=True):
    def f(x):
        s = torch.sort(x, dim=axis, stable=True).values
        return s if is_ascend else torch.flip(s, dims=(axis,))
    return invoke("sort", f, [_as_nd(data)], differentiable=False)


@_export
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    dt = torch_dtype(dtype)

    def f(x):
        s = torch.argsort(x, dim=axis, stable=True)
        return (s if is_ascend else torch.flip(s, dims=(axis,))).to(dt)
    return invoke("argsort", f, [_as_nd(data)], differentiable=False)


# ------------------------------------------------------------ linear algebra

def _t2(a):
    return a.transpose(-1, -2) if a.dim() > 1 else a


@_export
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    like = _first_nd(lhs, rhs)

    def f(a, b):
        a = _t2(a) if transpose_a else a
        b = _t2(b) if transpose_b else b
        # MXNet dot: the last axis of a against the first axis of b
        return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))
    return invoke("dot", f, [_as_nd(lhs, like), _as_nd(rhs, like)])


@_export
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    like = _first_nd(lhs, rhs)

    def f(a, b):
        return torch.matmul(a.transpose(-1, -2) if transpose_a else a,
                            b.transpose(-1, -2) if transpose_b else b)
    return invoke("batch_dot", f, [_as_nd(lhs, like), _as_nd(rhs, like)])


@_export
def matmul(lhs, rhs):
    like = _first_nd(lhs, rhs)
    return invoke("matmul", torch.matmul,
                  [_as_nd(lhs, like), _as_nd(rhs, like)])


@_export
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    like = _first_nd(A, B)

    def f(a, b):
        return alpha * torch.matmul(a.transpose(-1, -2) if transpose_a else a,
                                    b.transpose(-1, -2) if transpose_b else b)
    return invoke("linalg_gemm2", f, [_as_nd(A, like), _as_nd(B, like)])


@_export
def linalg_syrk(A, transpose=False, alpha=1.0):
    def f(a):
        at = a.transpose(-1, -2)
        return alpha * (torch.matmul(at, a) if transpose
                        else torch.matmul(a, at))
    return invoke("linalg_syrk", f, [_as_nd(A)])


@_export
def linalg_extractdiag(A, offset=0, **kw):
    return invoke("linalg_extractdiag",
                  lambda a: torch.diagonal(a, offset, -2, -1), [_as_nd(A)])


@_export
def linalg_makediag(A, offset=0, **kw):
    return invoke("linalg_makediag",
                  lambda a: torch.diag_embed(a, offset), [_as_nd(A)])


@_export
def linalg_potrf(A):
    """Lower Cholesky factor; a matrix that is not positive definite
    gives NaN, as jnp's does (no host read to find out)."""
    def f(a):
        lo, info = torch.linalg.cholesky_ex(a)
        bad = (info != 0)[..., None, None]
        return torch.where(bad, torch.full_like(lo, math.nan), lo)
    return invoke("linalg_potrf", f, [_as_nd(A)])


@_export
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(A)^-1 B`` (or ``alpha * B op(A)^-1`` with
    ``rightside``), ``op(A) = A^T`` with ``transpose``; only the
    ``lower`` (or upper) triangle of A is read."""
    like = _first_nd(A, B)

    def f(a, b):
        tri = torch.tril(a) if lower else torch.triu(a)
        if transpose:           # the transpose of a lower factor is upper
            tri = tri.transpose(-1, -2)
        upper = lower if transpose else not lower
        return alpha * torch.linalg.solve_triangular(
            tri, b, upper=upper, left=not rightside)
    return invoke("linalg_trsm", f, [_as_nd(A, like), _as_nd(B, like)])


@_export
def linalg_det(A, **kw):
    return invoke("linalg_det", torch.linalg.det, [_as_nd(A)])


@_export
def linalg_slogdet(A, **kw):
    return invoke("linalg_slogdet", lambda a: tuple(torch.linalg.slogdet(a)),
                  [_as_nd(A)])


@_export
def linalg_inverse(A, **kw):
    """The inverse; a singular matrix gives what LU gives (inf or NaN)
    instead of raising, as jnp's does."""
    return invoke("linalg_inverse", lambda a: torch.linalg.inv_ex(a)[0],
                  [_as_nd(A)])


# --------------------------------------------------------------- shape ops

def _mx_reshape_shape(src: Tuple[int, ...], spec: Tuple[int, ...],
                      reverse: bool) -> Tuple[int, ...]:
    """MXNet's reshape codes 0 (keep), -1 (infer), -2 (the rest), -3
    (merge two), -4 (split one)."""
    if reverse:
        rev = _mx_reshape_shape(tuple(reversed(src)),
                                tuple(reversed(spec)), False)
        return tuple(reversed(rev))
    out: list = []
    src_i = i = 0
    spec = tuple(spec)
    while i < len(spec):
        s = spec[i]
        if s == 0:
            out.append(src[src_i])
            src_i += 1
        elif s == -1:
            out.append(-1)
            src_i += 1
        elif s == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:
            a, b = spec[i + 1], spec[i + 2]
            dim = src[src_i]
            if a == -1:
                a = dim // b
            if b == -1:
                b = dim // a
            out.extend([a, b])
            src_i += 1
            i += 2
        else:
            out.append(int(s))
            src_i += 1
        i += 1
    if -1 in out:
        known = math.prod(v for v in out if v != -1)
        out[out.index(-1)] = math.prod(src) // known if known else 0
    return tuple(out)


@_export
def reshape(data, shape=None, reverse=False, **kw):
    data = _as_nd(data)
    tgt = _mx_reshape_shape(data.shape, tuple(shape), reverse)
    return invoke("reshape", lambda x: x.reshape(tgt), [data])


@_export
def transpose(data, axes=None):
    def f(x):
        return x.permute(tuple(axes) if axes else
                         tuple(reversed(range(x.dim()))))
    return invoke("transpose", f, [_as_nd(data)])


@_export
def swapaxes(data, dim1=0, dim2=1):
    return invoke("swapaxes", lambda x: torch.swapaxes(x, dim1, dim2),
                  [_as_nd(data)])


_alias("SwapAxis", swapaxes)


@_export
def flatten(data):
    data = _as_nd(data)
    n = data.shape[0] if data.ndim else 1
    return invoke("flatten", lambda x: x.reshape(n, -1), [data])


_alias("Flatten", flatten)


@_export
def expand_dims(data, axis):
    return invoke("expand_dims", lambda x: x.unsqueeze(axis), [_as_nd(data)])


@_export
def squeeze(data, axis=None):
    def f(x):
        if axis is None:
            return x.squeeze()
        return x.squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                         else axis)
    return invoke("squeeze", f, [_as_nd(data)])


@_export
def broadcast_to(data, shape):
    data = _as_nd(data)
    tgt = tuple(s if t == 0 else t for s, t in zip(data.shape, tuple(shape)))
    return invoke("broadcast_to", lambda x: x.expand(tgt), [data])


@_export
def broadcast_like(lhs, rhs):
    like = _first_nd(lhs, rhs)
    return invoke("broadcast_like", lambda a, b: a.expand(b.shape),
                  [_as_nd(lhs, like), _as_nd(rhs, like)])


@_export
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """Reshape lhs to rhs's shape, or dims [lhs_begin, lhs_end) of lhs to
    dims [rhs_begin, rhs_end) of rhs."""
    like = _first_nd(lhs, rhs)
    partial = any(v is not None for v in
                  (lhs_begin, lhs_end, rhs_begin, rhs_end))

    def f(a, b):
        if not partial:
            return a.reshape(b.shape)
        lb = 0 if lhs_begin is None else lhs_begin
        le = a.dim() if lhs_end is None else lhs_end
        rb = 0 if rhs_begin is None else rhs_begin
        re_ = b.dim() if rhs_end is None else rhs_end
        return a.reshape(a.shape[:lb] + b.shape[rb:re_] + a.shape[le:])
    return invoke("reshape_like", f, [_as_nd(lhs, like), _as_nd(rhs, like)])


@_export
def broadcast_axis(data, axis=(), size=()):
    data = _as_nd(data)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return invoke("broadcast_axis", lambda x: x.expand(tuple(tgt)), [data])


def _seq(data):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    like = _first_nd(*data)
    return [_as_nd(d, like) for d in data]


@_export
def concat(*data, dim=1, **kw):
    return invoke("concat", lambda *xs: torch.cat(xs, dim=dim), _seq(data))


_alias("Concat", concat)


@_export
def stack(*data, axis=0, **kw):
    return invoke("stack", lambda *xs: torch.stack(xs, dim=axis), _seq(data))


@_export
def split(data, num_outputs=None, axis=1, squeeze_axis=False):
    data = _as_nd(data)
    n = data.shape[axis]
    if n % num_outputs:
        raise _base.MXNetError(f"split: axis {axis} of size {n} does not "
                               f"divide into {num_outputs} outputs")

    def f(x):
        parts = torch.split(x, n // num_outputs, dim=axis)
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts)
    return invoke("split", f, [data])


_alias("SliceChannel", split)


def _flipped_slice(sl, n):
    """A negative-step slice of an axis of size ``n`` as the positive-step
    slice that picks the same elements, in the same order, from the axis
    flipped (torch has no negative-step slice)."""
    start, _stop, step = sl.indices(n)
    count = len(range(*sl.indices(n)))
    if not count:
        return builtins.slice(0, 0)
    first = n - 1 - start
    return builtins.slice(first, first + (count - 1) * -step + 1, -step)


@_export
def slice(data, begin, end, step=None):
    """``x[begin:end:step]`` per axis, ``None`` bounds as Python's.  A
    negative step flips the axis and slices it: the result is a copy
    where the reference's is a view, which no caller sees through
    ``nd``."""
    data = _as_nd(data)
    step = tuple(step) if step is not None else (None,) * len(begin)
    idx = [builtins.slice(b, e, s) for b, e, s in
           zip(tuple(begin), tuple(end), step)]
    flip = tuple(a for a, sl in enumerate(idx)
                 if sl.step is not None and sl.step < 0)
    for a in flip:
        idx[a] = _flipped_slice(idx[a], data.shape[a])
    idx = tuple(idx)
    if flip:
        return invoke("slice", lambda x: torch.flip(x, flip)[idx], [data])
    return invoke("slice", lambda x: x[idx], [data])


@_export
def slice_axis(data, axis, begin, end):
    def f(x):
        idx = [builtins.slice(None)] * x.dim()
        idx[axis] = builtins.slice(begin, end)
        return x[tuple(idx)]
    return invoke("slice_axis", f, [_as_nd(data)])


@_export
def slice_like(data, shape_like, axes=None):
    like = _first_nd(data, shape_like)

    def f(x, y):
        idx = [builtins.slice(None)] * x.dim()
        for a in (axes if axes is not None else range(y.dim())):
            idx[a] = builtins.slice(0, y.shape[a])
        return x[tuple(idx)]
    return invoke("slice_like", f, [_as_nd(data, like),
                                    _as_nd(shape_like, like)])


def _clip_index(idx, n, mode="clip"):
    idx = idx.long()
    return torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)


@_export
def take(a, indices, axis=0, mode="clip"):
    like = _first_nd(a, indices)

    def f(x, idx):
        ax = axis % x.dim()
        i = _clip_index(idx, x.shape[ax], mode)
        out = torch.index_select(x, ax, i.reshape(-1))
        return out.reshape(x.shape[:ax] + i.shape + x.shape[ax + 1:])
    return invoke("take", f, [_as_nd(a, like), _as_nd(indices, like)])


@_export
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    like = _first_nd(data, index)

    def f(x, idx):
        i = _clip_index(idx, x.shape[axis], mode).unsqueeze(axis)
        out = torch.gather(x, axis, i)
        return out if keepdims else out.squeeze(axis)
    return invoke("pick", f, [_as_nd(data, like), _as_nd(index, like)])


@_export
def choose_element_0index(data, index):
    return pick(data, index, axis=-1)


@_export
def gather_nd(data, indices):
    like = _first_nd(data, indices)

    def f(x, idx):
        idx = idx.long()
        return x[tuple(idx[i] for i in range(idx.shape[0]))]
    return invoke("gather_nd", f, [_as_nd(data, like),
                                   _as_nd(indices, like)])


@_export
def scatter_nd(data, indices, shape):
    """Scatter ``data`` into zeros of ``shape`` at ``indices`` (K, ...).
    Duplicate indices *add*, as the reference's ``.at[].add`` does
    (upstream MXNet keeps one of them)."""
    like = _first_nd(data, indices)

    def f(d, idx):
        idx = idx.long()
        z = torch.zeros(tuple(shape), dtype=d.dtype, device=d.device)
        return z.index_put(tuple(idx[i] for i in range(idx.shape[0])), d,
                           accumulate=True)
    return invoke("scatter_nd", f, [_as_nd(data, like),
                                    _as_nd(indices, like)])


def _unravel(flat, shape):
    """Coordinates (len(shape), ...) of flat ids, jnp's rule: a negative
    id counts from the end, then every id is clipped into the array."""
    size = math.prod(shape)
    flat = flat.long()
    flat = torch.where(flat < 0, flat + size, flat).clamp(0, builtins.max(
        size - 1, 0))
    coords = []
    for s in reversed(shape):
        coords.append(torch.remainder(flat, s))
        flat = torch.div(flat, s, rounding_mode="floor")
    return torch.stack(coords[::-1]).to(torch.int32)


@_export
def unravel_index(data, shape):
    return invoke("unravel_index", lambda i: _unravel(i, tuple(shape)),
                  [_as_nd(data)], differentiable=False)


@_export
def ravel_multi_index(data, shape):
    """Flat ids of coordinates ``data`` (len(shape), ...), each
    coordinate clipped into its axis (``mode='clip'``)."""
    shape = tuple(shape)

    def f(m):
        flat = torch.zeros(m.shape[1:], dtype=torch.long, device=m.device)
        for i, s in enumerate(shape):
            flat = flat * s + m[i].long().clamp(0, s - 1)
        return flat.to(torch.int32)
    return invoke("ravel_multi_index", f, [_as_nd(data)],
                  differentiable=False)


def _fill_value(dtype):
    """What jnp's gather fills an out-of-range index with: NaN for
    floats, the lowest value for signed integers, the highest for
    unsigned."""
    if dtype.is_floating_point:
        return math.nan
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


@_export
def batch_take(a, indices, **kw):
    """``out[i] = a[i, indices[i]]``: a negative index counts from the
    row's end, one past either end fills NaN (the reference's
    ``take_along_axis``; ``pick`` and ``take`` clip instead)."""
    like = _first_nd(a, indices)

    def f(x, idx):
        n = x.shape[1]
        i = idx.long().reshape(-1)
        i = torch.where(i < 0, i + n, i)
        inside = (i >= 0) & (i < n)
        got = torch.gather(x, 1, i.clamp(0, n - 1)[:, None])[:, 0]
        return torch.where(inside, got, torch.full_like(
            got, _fill_value(x.dtype)))
    return invoke("batch_take", f, [_as_nd(a, like), _as_nd(indices, like)])


@_export
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = torch_dtype(dtype)

    def f(idx):
        # out-of-range ids give an all-off row, as jax.nn.one_hot does
        hot = idx.long()[..., None] == torch.arange(depth,
                                                    device=idx.device)
        return hot.to(dt) * (on_value - off_value) + off_value
    return invoke("one_hot", f, [_as_nd(indices)], differentiable=False)


@_export
def tile(data, reps):
    return invoke("tile", lambda x: torch.tile(x, tuple(reps)),
                  [_as_nd(data)])


@_export
def repeat(data, repeats, axis=None):
    return invoke("repeat",
                  lambda x: torch.repeat_interleave(x, repeats, dim=axis),
                  [_as_nd(data)])


@_export
def flip(data, axis):
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return invoke("flip", lambda x: torch.flip(x, dims=dims), [_as_nd(data)])


_alias("reverse", flip)


@_export
def pad(data, mode="constant", pad_width=None, constant_value=0.0):
    pw = tuple(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    tmode = {"constant": "constant", "edge": "replicate",
             "reflect": "reflect"}[mode]

    if tmode != "constant":
        # torch pads the trailing dims only: MXNet leaves N and C alone
        while pairs and pairs[0] == (0, 0):
            pairs.pop(0)
    flat = [v for p in reversed(pairs) for v in p]

    def f(x):
        if tmode == "constant":
            return Fn.pad(x, flat, mode="constant", value=constant_value)
        return Fn.pad(x, flat, mode=tmode)
    return invoke("pad", f, [_as_nd(data)])


_alias("Pad", pad)


@_export
def arange_like(data, start=0.0, step=1.0, axis=None):
    def f(x):
        if axis is None:
            return (start + step * torch.arange(
                x.numel(), dtype=x.dtype, device=x.device)).reshape(x.shape)
        return start + step * torch.arange(x.shape[axis], dtype=x.dtype,
                                           device=x.device)
    return invoke("arange_like", f, [_as_nd(data)], differentiable=False)


@_export
def shape_array(data):
    data = _as_nd(data)
    return NDArray(torch.tensor(data.shape, dtype=torch.int64,
                                device=data._t.device))


@_export
def size_array(data):
    data = _as_nd(data)
    return NDArray(torch.tensor([data.size], dtype=torch.int64,
                                device=data._t.device))


@_export
def diag(data, k=0, axis1=0, axis2=1):
    def f(x):
        if x.dim() == 1:
            return torch.diag(x, k)
        return torch.diagonal(x, k, axis1, axis2)
    return invoke("diag", f, [_as_nd(data)])


@_export
def cumsum(a, axis=None, dtype=None, **kw):
    def f(x):
        y = torch.cumsum(x.reshape(-1) if axis is None else x,
                         dim=0 if axis is None else axis)
        return y.to(torch_dtype(dtype)) if dtype else y
    return invoke("cumsum", f, [_as_nd(a)])


@_export
def cumprod(a, axis=None, dtype=None, **kw):
    def f(x):
        y = torch.cumprod(x.reshape(-1) if axis is None else x,
                          dim=0 if axis is None else axis)
        return y.to(torch_dtype(dtype)) if dtype else y
    return invoke("cumprod", f, [_as_nd(a)])


@_export
def moments(data, axes=None, keepdims=False, **kw):
    """(mean, variance) over ``axes``."""
    data = _as_nd(data)
    ax = _axes(data.ndim, axes)

    def f(x):
        mk = torch.mean(x, dim=ax, keepdim=True)
        v = torch.mean((x - mk) ** 2, dim=ax, keepdim=keepdims)
        return (mk if keepdims else mk.squeeze(ax)), v
    return invoke("moments", f, [data], nout=2)


# ------------------------------------------------ softmax family, activations

@_export
def softmax(data, axis=-1, length=None, temperature=None, use_length=False):
    t = temperature or 1.0
    data = _as_nd(data)
    if length is None:
        return invoke("softmax", lambda x: torch.softmax(x / t, dim=axis),
                      [data])

    def f(x, ln):
        # positions >= length along `axis` are masked out
        n = x.shape[axis]
        shape = [1] * x.dim()
        shape[axis] = n
        ar = torch.arange(n, device=x.device).reshape(shape)
        mask = ar < ln.long().unsqueeze(axis)
        neg = torch.finfo(x.dtype).min
        masked = torch.where(mask, x / t, torch.full_like(x, neg))
        return torch.softmax(masked, dim=axis) * mask
    return invoke("softmax", f, [data, _as_nd(length, data)])


@_export
def log_softmax(data, axis=-1, temperature=None):
    t = temperature or 1.0
    return invoke("log_softmax",
                  lambda x: torch.log_softmax(x / t if t != 1.0 else x,
                                              dim=axis), [_as_nd(data)])


@_export
def logsumexp(data, axis=-1, keepdims=False):
    """log(sum(exp(x))) along ``axis``, in float32."""
    return invoke("logsumexp",
                  lambda x: torch.logsumexp(x.float(), dim=axis,
                                            keepdim=keepdims),
                  [_as_nd(data)])


@_export
def softmax_cross_entropy(data, label):
    like = _first_nd(data, label)

    def f(x, y):
        ls = torch.log_softmax(x, dim=-1)
        return -torch.sum(torch.gather(ls, -1, y.long()[:, None]))
    return invoke("softmax_cross_entropy", f,
                  [_as_nd(data, like), _as_nd(label, like)])


def _mish(x):
    return x * torch.tanh(Fn.softplus(x))


ACTIVATION_FNS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": Fn.softplus, "softsign": Fn.softsign,
    "log_sigmoid": Fn.logsigmoid, "mish": _mish,
    # jax.nn.gelu's default, the tanh approximation
    "gelu": lambda x: Fn.gelu(x, approximate="tanh"), "silu": Fn.silu}


@_export
def Activation(data, act_type="relu", **kw):
    return invoke(f"activation_{act_type}", ACTIVATION_FNS[act_type],
                  [_as_nd(data)])


@_export
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, **kw):
    data = _as_nd(data)
    if act_type == "leaky":
        return invoke("leaky_relu", lambda x: Fn.leaky_relu(x, slope), [data])
    if act_type == "elu":
        return invoke("elu", lambda x: Fn.elu(x, alpha=slope), [data])
    if act_type == "selu":
        return invoke("selu", Fn.selu, [data])
    if act_type == "gelu":
        return invoke("gelu", Fn.gelu, [data])
    if act_type == "prelu":
        return invoke("prelu", lambda x, a: torch.where(x >= 0, x, a * x),
                      [data, _as_nd(gamma, data)])
    if act_type == "rrelu":
        if _base.is_training():
            def f(x):
                s = torch.rand(x.shape, device=x.device,
                               generator=_random.generator(x.device))
                s = lower_bound + (upper_bound - lower_bound) * s
                return torch.where(x >= 0, x, s.to(x.dtype) * x)
            return invoke("rrelu", f, [data])
        mid = (lower_bound + upper_bound) / 2.0
        return invoke("rrelu", lambda x: torch.where(x >= 0, x, mid * x),
                      [data])
    raise ValueError(f"unknown LeakyReLU act_type {act_type}")


@_export
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return invoke("hard_sigmoid",
                  lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0),
                  [_as_nd(data)])


@_export
def relu6(data):
    return invoke("relu6", lambda x: torch.clamp(x, 0.0, 6.0), [_as_nd(data)])


@_export
def selu(data):
    return invoke("selu", Fn.selu, [_as_nd(data)])


@_export
def gelu(data):
    """The exact erf form."""
    return invoke("gelu", Fn.gelu, [_as_nd(data)])


@_export
def prelu(data, gamma):
    like = _first_nd(data, gamma)

    def f(x, g):
        gshape = [1] * x.dim()
        if x.dim() > 1:
            gshape[1] = -1
        return torch.where(x >= 0, x, x * g.reshape(gshape))
    return invoke("prelu", f, [_as_nd(data, like), _as_nd(gamma, like)])


# ------------------------------------------------------------- neural ops

@_export
def FullyConnected(data, weight, bias=None, num_hidden=None,
                   no_bias=False, flatten=True, **kw):
    """weight is (out, in); with ``flatten`` the input is (N, -1)."""
    nds = [_as_nd(data), _as_nd(weight, data)]
    if bias is not None and not no_bias:
        nds.append(_as_nd(bias, data))

    def f(x, w, *b):
        if flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return Fn.linear(x, w, b[0] if b else None)
    return invoke("FullyConnected", f, nds)


@_export
def Embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False, **kw):
    like = _first_nd(data, weight)
    weight = _as_nd(weight, like)
    # a recorded lookup of a leaf weight outside a compiled program
    # gives a sparse gradient (compact in a row-sparse buffer, added
    # into a dense one), as the reference's eager sparse_grad path
    sparse = bool(sparse_grad) and _base.is_recording() and \
        weight._t.is_leaf and weight._t.requires_grad and not _in_program()

    def f(idx, w):
        return Fn.embedding(_clip_index(idx, w.shape[0]), w, sparse=sparse)
    return invoke("Embedding", f, [_as_nd(data, like), weight])


def _in_program():
    from ..utils.graphs import in_program
    return in_program()


@_export
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, **kw):
    like = _first_nd(data, gamma, beta)

    def f(x, g, b):
        mean_ = torch.mean(x, dim=axis, keepdim=True)
        var = torch.var(x, dim=axis, unbiased=False, keepdim=True)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        return (x - mean_) * torch.rsqrt(var + eps) * g.reshape(shape) \
            + b.reshape(shape)
    return invoke("LayerNorm", f, [_as_nd(v, like)
                                   for v in (data, gamma, beta)])


@_export
def L2Normalization(data, eps=1e-10, mode="instance"):
    def f(x):
        if mode == "instance":
            axes = tuple(range(1, x.dim()))
        elif mode == "channel":
            axes = (1,)
        else:  # spatial
            axes = tuple(range(2, x.dim()))
        return x / torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                        keepdim=True) + eps)
    return invoke("L2Normalization", f, [_as_nd(data)])


@_export
def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False, **kw):
    """Inverted dropout, in training mode (or ``mode='always'``); the
    mask comes from the device's generator in :mod:`..random`."""
    data = _as_nd(data)
    if (not _base.is_training() and mode != "always") or p <= 0:
        return invoke("dropout_id", lambda x: x.view_as(x), [data])

    def f(x):
        shape = list(x.shape)
        for a in axes:
            shape[a] = 1        # one draw shared along these axes
        draw = torch.rand(shape, device=x.device,
                          generator=_random.generator(x.device))
        return torch.where(draw < 1.0 - p, x / (1.0 - p),
                           torch.zeros_like(x))
    return invoke("Dropout", f, [data])


@_export
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar

    def f(x):
        return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                           torch.abs(x) - 0.5 / s2)
    return invoke("smooth_l1", f, [_as_nd(data)])


@_export
def MakeLoss(data, grad_scale=1.0, **kw):
    return invoke("make_loss", lambda x: x * grad_scale, [_as_nd(data)])


@_export
def make_loss(data, **kw):
    return MakeLoss(data, **kw)


@_export
def BlockGrad(data):
    return _as_nd(data).detach()


_alias("stop_gradient", BlockGrad)


@_export
def div_sqrt_dim(data):
    return invoke("div_sqrt_dim", lambda x: x / math.sqrt(x.shape[-1]),
                  [_as_nd(data)])


@_export
def add_n(*args, **kw):
    """The sum of a list of arrays."""
    def f(*xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc
    return invoke("add_n", f, _seq(args))


# ------------------------------------ vision: convolution, pooling, norms
#
# Each op has a tensor function (``conv``, ``deconv``, ``pool``,
# ``batch_norm``, ...) that the ``gluon.nn`` layers call on their tensors
# after ``amp.cast``, and an ``nd`` op of the reference's name and
# signature that runs it through ``invoke``.  A channels-last layout
# (``NWC``/``NHWC``/``NDHWC``) runs on ``x.movedim(-1, 1)``: for a
# contiguous tensor that view is torch's channels_last memory format,
# which cuDNN convolves and pools natively, and the result moves back the
# same way.  Weights are (O, I, *k) in every layout.

CHANNELS_LAST_LAYOUTS = ("NWC", "NHWC", "NDHWC")
_LAYOUT_NDIM = {"NCW": 3, "NWC": 3, "NCHW": 4, "NHWC": 4, "NCDHW": 5,
                "NDHWC": 5}
_CONV = {1: Fn.conv1d, 2: Fn.conv2d, 3: Fn.conv3d}
_CONV_T = {1: Fn.conv_transpose1d, 2: Fn.conv_transpose2d,
           3: Fn.conv_transpose3d}
_MAX_POOL = {1: Fn.max_pool1d, 2: Fn.max_pool2d, 3: Fn.max_pool3d}
_AVG_POOL = {1: Fn.avg_pool1d, 2: Fn.avg_pool2d, 3: Fn.avg_pool3d}


def check_conv_layout(ndim, layout):
    """Raise as the reference's ``_conv_dim_numbers`` does for a layout
    that does not fit ``ndim``-d data."""
    if layout in (None, "NCW", "NCHW", "NCDHW"):
        if layout is not None and len(layout) != ndim:
            raise _base.MXNetError(
                f"conv layout {layout!r} expects {len(layout)}-d input, "
                f"got {ndim}-d")
    elif _LAYOUT_NDIM.get(layout) != ndim:
        raise _base.MXNetError(f"unsupported conv layout {layout!r} for "
                               f"{ndim}-d input")


def channels_first(x, layout):
    """``x`` in ``layout`` as an (N, C, *spatial) view."""
    return x.movedim(-1, 1) if layout in CHANNELS_LAST_LAYOUTS else x


def channels_back(y, layout):
    """An (N, C, *spatial) result in ``layout``."""
    return y.movedim(1, -1) if layout in CHANNELS_LAST_LAYOUTS else y


def _spatial(v, n, default):
    return tuple(v) if v else (default,) * n


def conv(x, w, b, stride=None, dilate=None, pad=None, groups=1,
         layout=None):
    """N-d convolution of ``x`` in ``layout`` by (O, I/groups, *k)
    weights ``w``, plus ``b`` (None: no bias)."""
    n = x.dim() - 2
    y = _CONV[n](channels_first(x, layout), w, b, _spatial(stride, n, 1),
                 _spatial(pad, n, 0), _spatial(dilate, n, 1), groups)
    return channels_back(y, layout)


def deconv(x, w, b, stride=None, dilate=None, pad=None, groups=1):
    """Transposed convolution of channels-first ``x`` by (Cin, Cout/groups,
    *k) weights, output size ``(in - 1) * stride + (k - 1) * dilate + 1 -
    2 * pad`` (the reference's; MXNet's ``adj`` is not applied)."""
    n = x.dim() - 2
    return _CONV_T[n](x, w, b, _spatial(stride, n, 1), _spatial(pad, n, 0),
                      0, groups, _spatial(dilate, n, 1))


def pool(x, kernel=None, pool_type="max", global_pool=False, stride=None,
         pad=None, pooling_convention="valid", count_include_pad=True,
         layout=None, p_value=2):
    """The reference's ``Pooling`` on a tensor.  ``full`` pads the upper
    side so a last partial window fits (the reference's ceil rule, which
    keeps a window that starts in the padding, where torch's ``ceil_mode``
    drops it); such padding is explicit (-inf for max, 0 otherwise) and
    the windows then lie inside the padded input, so an average divides
    by the whole window or, without ``count_include_pad``, by the count
    of real elements in it."""
    n = x.dim() - 2
    if global_pool:
        sp0 = 1 if layout in CHANNELS_LAST_LAYOUTS else 2
        axes = tuple(range(sp0, sp0 + n))
        if pool_type == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        return torch.mean(x, dim=axes, keepdim=True)
    k = tuple(kernel)
    s = tuple(stride) if stride else k
    p = _spatial(pad, n, 0)
    xc = channels_first(x, layout)
    hi = list(p)
    if pooling_convention == "full":
        for i in range(n):
            size = xc.shape[2 + i] + 2 * p[i]
            out = int(math.ceil((size - k[i]) / s[i])) + 1
            hi[i] += builtins.max((out - 1) * s[i] + k[i] - size, 0)
    # torch pads by itself only evenly and by at most half a window; its
    # CUDA average pooling's backward on channels-last data that it pads
    # itself gives wrong gradients (torch 2.11), so averages pad here
    native = tuple(hi) == p and all(2 * a <= b for a, b in zip(p, k)) \
        and (pool_type == "max" or not any(p))

    def padded(t, fill):
        flat = [v for i in reversed(range(n)) for v in (p[i], hi[i])]
        return Fn.pad(t, flat, value=fill)

    if pool_type == "max":
        if native:
            y = _MAX_POOL[n](xc, k, s, p)
        else:
            fill = -math.inf if xc.is_floating_point() else \
                torch.iinfo(xc.dtype).min
            y = _MAX_POOL[n](padded(xc, fill), k, s)
        return channels_back(y, layout)
    if pool_type not in ("avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type}")
    src = xc.abs() ** p_value if pool_type == "lp" else xc
    mean_of_real = pool_type == "avg" and not count_include_pad
    if native:
        y = _AVG_POOL[n](src, k, s)
    else:
        y = _AVG_POOL[n](padded(src, 0.0), k, s)
        if mean_of_real:     # over the real elements' share of a window
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]),
                              dtype=xc.dtype, device=xc.device)
            y = y / _AVG_POOL[n](padded(ones, 0.0), k, s)
    if pool_type != "avg":
        y = y * math.prod(k)
        if pool_type == "lp":
            y = y ** (1.0 / p_value)
    return channels_back(y, layout)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               fix_gamma=False, training=True, axis=1):
    """(out, mean, var): ``x`` normalized along channel axis ``axis`` by
    its batch statistics (``training``; the biased variance) or by the
    moving ones.  ``fix_gamma`` scales by 1."""
    ax = axis % x.dim()
    xc = x.movedim(ax, 1)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training:
        dims = [i for i in range(xc.dim()) if i != 1]
        var, mean = torch.var_mean(xc, dim=dims, unbiased=False)
    else:
        mean, var = moving_mean, moving_var
    if training and xc.numel() > xc.shape[1]:
        out = Fn.batch_norm(xc, None, None, g, beta, True, 0.0, eps)
    else:
        # elementwise: the moving statistics take gradients too, and one
        # value per channel (which F.batch_norm refuses) normalizes to 0
        c = (-1,) + (1,) * (xc.dim() - 2)
        out = (xc - mean.reshape(c)) * torch.rsqrt(var + eps).reshape(c) \
            * g.reshape(c) + beta.reshape(c)
    return out.movedim(1, ax), mean, var


class _SoftmaxOutput(torch.autograd.Function):
    """softmax forward; the backward ignores the incoming gradient and
    gives ``(p - onehot(label)) * grad_scale``, masked and normalized."""

    @staticmethod
    def forward(ctx, x, label, grad_scale, use_ignore, ignore_label,
                normalization):
        p = torch.softmax(x, dim=-1)
        ctx.save_for_backward(p, label)
        ctx.cfg = (grad_scale, use_ignore, ignore_label, normalization)
        return p

    @staticmethod
    def backward(ctx, _g):
        p, label = ctx.saved_tensors
        grad_scale, use_ignore, ignore_label, normalization = ctx.cfg
        y = label.to(torch.int32)
        # an out-of-range label gives an all-zero row, as jax.nn.one_hot
        onehot = (y[..., None] == torch.arange(p.shape[-1],
                                               device=p.device)).to(p.dtype)
        dx = (p - onehot) * grad_scale
        valid = None
        if use_ignore:
            valid = y != ignore_label
            dx = dx * valid[..., None].to(p.dtype)
        if normalization == "batch":
            dx = dx / p.shape[0]
        elif normalization == "valid":
            count = valid.sum().to(p.dtype) if valid is not None else \
                torch.tensor(float(label.numel()), dtype=p.dtype)
            dx = dx / torch.clamp(count, min=1)
        return dx, None, None, None, None, None


class _LinearRegressionOutput(torch.autograd.Function):
    """identity forward; the backward gives ``(x - label) * grad_scale``
    whatever the incoming gradient."""

    @staticmethod
    def forward(ctx, x, label, grad_scale):
        ctx.save_for_backward(x, label)
        ctx.grad_scale = grad_scale
        return x.clone()

    @staticmethod
    def backward(ctx, _g):
        x, label = ctx.saved_tensors
        return (x - label.reshape(x.shape)) * ctx.grad_scale, None, None


@_export
def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **kw):
    """NCHW (default) or channels-last via ``layout``; (O, I, *k)
    weights either way."""
    data = _as_nd(data)
    check_conv_layout(data.ndim, layout)
    nds = [data, _as_nd(weight, data)]
    if bias is not None and not no_bias:
        nds.append(_as_nd(bias, data))
    return invoke("Convolution", lambda x, w, *b: conv(
        x, w, b[0] if b else None, stride, dilate, pad, num_group, layout),
        nds)


@_export
def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=True, layout=None, **kw):
    """Transposed convolution, channels-first only, weights (Cin,
    Cout/groups, *k).  ``adj`` and ``target_shape`` are accepted and not
    applied, as in the reference (ROADMAP queue C)."""
    data = _as_nd(data)
    check_conv_layout(data.ndim, layout)
    if layout in CHANNELS_LAST_LAYOUTS:
        raise _base.MXNetError(
            "channels-last layout is not supported for Deconvolution "
            "(runs NCHW)")
    nds = [data, _as_nd(weight, data)]
    if bias is not None and not no_bias:
        nds.append(_as_nd(bias, data))
    return invoke("Deconvolution", lambda x, w, *b: deconv(
        x, w, b[0] if b else None, stride, dilate, pad, num_group), nds)


@_export
def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None, **kw):
    """max / avg / sum / lp pooling (see :func:`pool`), NCHW or
    channels-last via ``layout``."""
    data = _as_nd(data)
    if layout is not None:
        if layout not in _LAYOUT_NDIM:
            raise _base.MXNetError(f"unsupported pooling layout {layout!r}")
        if _LAYOUT_NDIM[layout] != data.ndim:
            raise _base.MXNetError(
                f"pooling layout {layout!r} expects "
                f"{_LAYOUT_NDIM[layout]}-d input, got {data.ndim}-d")
    return invoke("Pooling", lambda x: pool(
        x, kernel, pool_type, global_pool, stride, pad, pooling_convention,
        count_include_pad, layout, kw.get("p_value", 2)), [data])


@_export
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=False, use_global_stats=False,
              output_mean_var=False, axis=1, **kw):
    """The normalized data, or with ``output_mean_var`` (out, batch mean,
    batch variance).  Functional, as the reference's: the Gluon layer
    updates the moving statistics."""
    like = _first_nd(data, gamma, beta, moving_mean, moving_var)
    nds = [_as_nd(v, like) for v in (data, gamma, beta, moving_mean,
                                     moving_var)]
    training = _base.is_training() and not use_global_stats
    out, mean, var = invoke("BatchNorm", lambda x, g, b, mm, mv: batch_norm(
        x, g, b, mm, mv, eps, fix_gamma, training, axis), nds)
    if output_mean_var or kw.get("_internal_stats"):
        return out, mean, var
    return out


@_export
def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5, **kw):
    like = _first_nd(data, gamma, beta)
    return invoke("GroupNorm", lambda x, g, b: Fn.group_norm(
        x, num_groups, g, b, eps), [_as_nd(v, like)
                                    for v in (data, gamma, beta)])


@_export
def InstanceNorm(data, gamma, beta, eps=1e-3, **kw):
    """Per sample and channel over the spatial axes (GroupNorm with a
    group per channel)."""
    like = _first_nd(data, gamma, beta)
    return invoke("InstanceNorm", lambda x, g, b: Fn.group_norm(
        x, x.shape[1], g, b, eps), [_as_nd(v, like)
                                    for v in (data, gamma, beta)])


@_export
def SoftmaxOutput(data, label=None, grad_scale=1.0, ignore_label=-1,
                  use_ignore=False, normalization="null", out_grad=False,
                  **kw):
    """softmax of ``data``; its gradient is the loss head's
    ``(softmax - onehot(label)) * grad_scale`` per ``normalization``
    ('null' | 'batch' | 'valid'), whatever flows in."""
    data = _as_nd(data)
    if label is None:
        return softmax(data, axis=-1)
    return invoke("SoftmaxOutput", lambda x, y: _SoftmaxOutput.apply(
        x, y, grad_scale, use_ignore, ignore_label, normalization),
        [data, _as_nd(label, data)])


@_export
def LinearRegressionOutput(data, label=None, grad_scale=1.0, **kw):
    """identity; its gradient is ``(data - label) * grad_scale``."""
    data = _as_nd(data)
    if label is None:
        return data
    return invoke("LinearRegressionOutput",
                  lambda x, y: _LinearRegressionOutput.apply(x, y,
                                                             grad_scale),
                  [data, _as_nd(label, data)])


@_export
def UpSampling(data, scale=2, sample_type="nearest", **kw):
    """(N, C, H, W) → (N, C, H·scale, W·scale): nearest repeats; bilinear
    samples at half-pixel centers (``jax.image.resize``'s)."""
    def f(x):
        if sample_type == "nearest":
            return x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
        return Fn.interpolate(x, size=(x.shape[2] * scale,
                                       x.shape[3] * scale),
                              mode="bilinear", align_corners=False)
    return invoke("UpSampling", f, [_as_nd(data)])


@_export
def Crop(data, *like, offset=(0, 0), h_w=(0, 0), center_crop=False, **kw):
    """(N, C, H, W) cropped to the spatial size of ``like[0]`` or to
    ``h_w``, at ``offset`` or centered."""
    data = _as_nd(data)
    nds = [data] + ([_as_nd(like[0], data)] if like else [])

    def f(x, *rest):
        th, tw = (rest[0].shape[2], rest[0].shape[3]) if rest else h_w
        if center_crop:
            y0, x0 = (x.shape[2] - th) // 2, (x.shape[3] - tw) // 2
        else:
            y0, x0 = offset
        return x[:, :, y0:y0 + th, x0:x0 + tw]
    return invoke("Crop", f, nds)


@_export
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """Local response normalization across channels; alpha is divided by
    the window size, as MXNet's ``lrn-inl.h`` does."""
    def f(x):
        c, half = x.shape[1], nsize // 2
        sq = Fn.pad(x * x, [0, 0] * (x.dim() - 2) + [half, half])
        acc = builtins.sum(sq.narrow(1, i, c) for i in range(nsize))
        return x / torch.pow(knorm + (alpha / nsize) * acc, beta)
    return invoke("LRN", f, [_as_nd(data)])


@_export
def SoftmaxActivation(data, mode="instance", **kw):
    """softmax over axis 1 (``channel``) or over every non-batch axis
    flattened (``instance``)."""
    def f(x):
        if mode == "channel":
            return torch.softmax(x, dim=1)
        return torch.softmax(x.reshape(x.shape[0], -1), dim=-1) \
            .reshape(x.shape)
    return invoke("SoftmaxActivation", f, [_as_nd(data)])


@_export
def depth_to_space(data, block_size, **kw):
    """(N, C·b·b, H, W) → (N, C, H·b, W·b), MXNet's DCR order."""
    b = int(block_size)

    def f(x):
        n, c, h, w = x.shape
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(n, c // (b * b), h * b, w * b)
    return invoke("depth_to_space", f, [_as_nd(data)])


@_export
def space_to_depth(data, block_size, **kw):
    """(N, C, H·b, W·b) → (N, C·b·b, H, W)."""
    b = int(block_size)

    def f(x):
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(n, c * b * b, h // b, w // b)
    return invoke("space_to_depth", f, [_as_nd(data)])


# ------------------------------------------------------ sequence / RNN ops

def _seq_shape(x, axis, n):
    """A shape of ``x.dim()`` ones but ``n`` at ``axis``."""
    shape = [1] * x.dim()
    shape[axis] = n
    return shape


@_export
def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):
    """Positions at or past each row's length along ``axis`` (0: time
    major, the batch on axis 1; else the batch on axis 0) set to
    ``value``."""
    data = _as_nd(data)
    if not use_sequence_length or sequence_length is None:
        return invoke("seqmask_id", lambda x: x.view_as(x), [data])

    def f(x, ln):
        ar = torch.arange(x.shape[axis], device=x.device)
        batch_axis = 1 if axis == 0 else 0
        keep = ar.reshape(_seq_shape(x, axis, x.shape[axis])) < \
            ln.to(torch.int32).reshape(
                _seq_shape(x, batch_axis, x.shape[batch_axis]))
        return torch.where(keep, x, torch.full_like(x, value))
    return invoke("SequenceMask", f, [data, _as_nd(sequence_length, data)])


@_export
def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):
    """Each row's last valid step along ``axis`` (the last step without
    lengths)."""
    data = _as_nd(data)
    if not use_sequence_length or sequence_length is None:
        return invoke("SequenceLast", lambda x: x.select(axis, -1), [data])

    def f(x, ln):
        xm = x.movedim(axis, 0)
        idx = (ln.long() - 1).reshape((1, -1) + (1,) * (xm.dim() - 2))
        return torch.gather(xm, 0, idx.expand((1,) + xm.shape[1:]))[0]
    return invoke("SequenceLast", f, [data, _as_nd(sequence_length, data)])


@_export
def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    """Each row's first ``length`` steps reversed along ``axis`` (0:
    time major), the padding after them left in place; all steps without
    lengths."""
    data = _as_nd(data)
    if not use_sequence_length or sequence_length is None:
        return invoke("SequenceReverse", lambda x: torch.flip(x, (axis,)),
                      [data])

    def f(x, ln):
        xm = x.movedim(axis, 0)                     # (T, B, ...)
        ar = torch.arange(xm.shape[0], device=x.device)[:, None]
        n = ln.long()[None, :]
        src = torch.where(ar < n, n - 1 - ar, ar)
        src = src.reshape(src.shape + (1,) * (xm.dim() - 2))
        return torch.gather(xm, 0, src.expand(xm.shape)).movedim(0, axis)
    return invoke("SequenceReverse", f, [data, _as_nd(sequence_length,
                                                     data)])


def _interleaved(x, heads, which):
    """Part ``which`` (0 q, 1 k, 2 v) of the (T, B, 3·H·D) layout
    interleaved per head ([q h0, k h0, v h0, q h1, ...]) as
    (B·H, T, D)."""
    t, b, e3 = x.shape
    hd = e3 // (3 * heads)
    part = x.reshape(t, b, heads, 3, hd)[:, :, :, which, :]
    return part.permute(1, 2, 0, 3).reshape(b * heads, t, hd)


@_export
def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """(T, B, 3·H·D) interleaved q/k/v → (B·H, T, T) scores
    ``(q / sqrt(D)) · kᵀ`` (the fused self-attention op of MXNet's
    ``contrib/transformer.cc``)."""
    def f(x):
        q, k = _interleaved(x, heads, 0), _interleaved(x, heads, 1)
        scale = 1.0 / math.sqrt(q.shape[-1])
        return torch.matmul(q * scale, k.transpose(-1, -2))
    return invoke("interleaved_matmul_selfatt_qk", f,
                  [_as_nd(queries_keys_values)])


@_export
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads):
    """Attention weights (B·H, T, T) over the interleaved v → (T, B,
    H·D)."""
    def f(x, a):
        t, b = x.shape[0], x.shape[1]
        out = torch.matmul(a, _interleaved(x, heads, 2))   # (B·H, T, D)
        return out.reshape(b, heads, t, -1).permute(2, 0, 1, 3) \
            .reshape(t, b, -1)
    qkv = _as_nd(queries_keys_values)
    return invoke("interleaved_matmul_selfatt_valatt", f,
                  [qkv, _as_nd(attention, qkv)])


@_export
def RNN(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=True, projection_size=None, **kw):
    """Fused multi-layer RNN over (T, B, C) ``data`` with MXNet's flat
    parameter vector (all weights, layer-major, i2h then h2h per layer
    and direction, then all biases) — see
    :func:`mxnet_tpu_torch.gluon.rnn._rnn_impl.rnn_forward`."""
    from ..gluon.rnn._rnn_impl import rnn_forward   # lazy: avoids a cycle
    return rnn_forward(data, parameters, state, state_cell, state_size,
                       num_layers, mode, bidirectional, p, state_outputs)


# the sibling modules import this one's helpers, so they come last
from . import detection as _detection  # noqa: E402
from . import sampling as _sampling  # noqa: E402

for _m in (_sampling, _detection):
    for _nm in _m.__all__:
        _alias(_nm, getattr(_m, _nm))
