"""``mx.npx`` — the numpy-extension namespace (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``; parity: MXNet 2.x ``mx.npx``).

The deep-learning ops outside the NumPy standard delegate to the port's
``mx.nd`` implementations (the same functions, so autograd, ``amp``
and the compiled programs treat them alike); ``masked_softmax``,
``masked_log_softmax`` and ``reshape`` (MXNet 2.x's special codes) are
torch ops dispatched as ``nd`` ops are; ``nonzero`` reads its
data-dependent size from the device.  The np state (``set_np``,
``use_np``, ``np_shape``, ``np_array``, ...) is per thread, as the
reference's.
"""
from __future__ import annotations

import functools as _functools
import threading as _threading

import torch

from .. import base as _base
from ..ndarray import ops as _nd
from ..ndarray.ndarray import NDArray

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape",
           "is_np_default_dtype", "use_np", "np_shape", "np_array"]

_np_state = _threading.local()


def set_np(shape=True, array=True, dtype=False):
    _np_state.shape = shape
    _np_state.array = array
    _np_state.dtype = dtype


def reset_np():
    set_np(False, False, False)


def is_np_array():
    return getattr(_np_state, "array", False)


def is_np_shape():
    return getattr(_np_state, "shape", False)


def is_np_default_dtype():
    return getattr(_np_state, "dtype", False)


class _NpScope:
    """Set the np state for a ``with`` block or a decorated function,
    and give the previous state back after it."""

    def __init__(self, shape=True, array=True, dtype=False):
        self._new = (shape, array, dtype)

    def __enter__(self):
        self._old = (is_np_shape(), is_np_array(), is_np_default_dtype())
        set_np(*self._new)
        return self

    def __exit__(self, *a):
        set_np(*self._old)

    def __call__(self, fn):
        @_functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _NpScope(*self._new):
                return fn(*args, **kwargs)
        return wrapped


def use_np(fn=None):
    scope = _NpScope(True, True, False)
    return scope(fn) if fn is not None else scope


def np_shape(active=True):
    return _NpScope(active, is_np_array(), is_np_default_dtype())


def np_array(active=True):
    return _NpScope(is_np_shape(), active, is_np_default_dtype())


# ----------------------------------------------------------- op delegation

_DELEGATED = [
    # activations / nn
    "relu", "sigmoid", "softmax", "log_softmax", "softplus", "softsign",
    "erf", "erfinv", "gamma", "gammaln",
    # layers
    "activation", "batch_norm", "layer_norm", "group_norm", "instance_norm",
    "convolution", "deconvolution", "fully_connected", "pooling", "dropout",
    "embedding", "rnn", "leaky_relu", "l2_normalization",
    # indexing / shape
    "one_hot", "pick", "topk", "gather_nd", "scatter_nd", "reshape_like",
    "broadcast_like", "arange_like", "shape_array", "slice", "slice_axis",
    "slice_like", "sequence_mask", "batch_dot",
    # misc
    "smooth_l1", "multibox_detection", "multibox_prior",
    "multibox_target", "sample_multinomial", "batch_flatten",
    "roi_pooling",
]

_ALIAS_TO_ND = {
    "activation": "Activation", "batch_norm": "BatchNorm",
    "layer_norm": "LayerNorm", "group_norm": "GroupNorm",
    "instance_norm": "InstanceNorm", "convolution": "Convolution",
    "deconvolution": "Deconvolution", "fully_connected": "FullyConnected",
    "pooling": "Pooling", "dropout": "Dropout", "embedding": "Embedding",
    "rnn": "RNN", "leaky_relu": "LeakyReLU",
    "l2_normalization": "L2Normalization", "sequence_mask": "SequenceMask",
    "multibox_detection": "MultiBoxDetection",
    "multibox_prior": "MultiBoxPrior", "multibox_target": "MultiBoxTarget",
    "batch_flatten": "Flatten", "roi_pooling": "ROIPooling",
}

for _name in _DELEGATED:
    _fn = getattr(_nd, _ALIAS_TO_ND.get(_name, _name), None)
    if _fn is not None:
        globals()[_name] = _fn
        __all__.append(_name)


def save(file, arr):
    """Save a dict of arrays (the ``nd.save`` container)."""
    from .. import ndarray as _ndmod
    _ndmod.save(file, arr)


def load(file):
    from .. import ndarray as _ndmod
    return _ndmod.load(file)


def waitall():
    from .. import ndarray as _ndmod
    _ndmod.waitall()


def seed(s):
    from .. import random as _random
    _random.seed(int(s))


from ..context import cpu, gpu, num_gpus  # noqa: E402,F401
from ..context import current_context as current_device  # noqa: E402,F401


def _masked(data, mask, axis, temperature, log):
    nds = [_nd._as_nd(data)]
    if mask is not None:
        nds.append(_nd._as_nd(mask, nds[0]))

    def f(x, *m):
        x = x / temperature
        if m:
            keep = m[0].bool()
            x = torch.where(keep, x, torch.full_like(x, -1e30))
        if log:
            out = x - torch.logsumexp(x, dim=axis, keepdim=True)
            if m:
                out = torch.where(keep, out, torch.full_like(out,
                                                             -float("inf")))
            return out
        e = torch.exp(x - torch.amax(x, dim=axis, keepdim=True))
        if m:
            e = torch.where(keep, e, torch.zeros_like(e))
        s = torch.sum(e, dim=axis, keepdim=True)
        return torch.where(s > 0, e / torch.clamp(s, min=1e-30),
                           torch.zeros_like(e))

    return _nd.invoke("masked_log_softmax" if log else "masked_softmax", f,
                      nds)


def masked_softmax(data, mask=None, axis=-1, temperature=1.0):
    """Softmax over the positions where ``mask`` is true; masked
    positions get probability 0 (an all-masked row gets 0)."""
    return _masked(data, mask, axis, temperature, log=False)


def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0):
    """Log-softmax over the unmasked positions; masked ones get -inf."""
    return _masked(data, mask, axis, temperature, log=True)


def _npx_reshape_shape(in_shape, newshape):
    """Resolve MXNet 2.x's npx.reshape special codes (parity:
    NumpyXReshapeInferShape): -1 infer, -2 copy the input dim, -3 skip a
    size-1 input dim, -4 copy every remaining input dim, -5 fuse two
    input dims, -6 split an input dim into the next two entries (one may
    be -1); 0 is a literal zero-size dim."""
    out, i, j = [], 0, 0
    ns = list(newshape)
    infer_pos = None
    while j < len(ns):
        s = int(ns[j])
        if s >= 0:
            out.append(s)
            i += 1
        elif s == -1:
            if infer_pos is not None:
                raise _base.MXNetError("npx.reshape: at most one -1")
            infer_pos = len(out)
            out.append(-1)
            i += 1
        elif s == -2:
            out.append(in_shape[i])
            i += 1
        elif s == -3:
            if in_shape[i] != 1:
                raise _base.MXNetError(
                    f"npx.reshape: -3 skips a size-1 dim, input dim {i} "
                    f"has size {in_shape[i]}")
            i += 1
        elif s == -4:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif s == -5:
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif s == -6:
            a, b = int(ns[j + 1]), int(ns[j + 2])
            j += 2
            d = in_shape[i]
            i += 1
            if a == -1:
                a = d // b
            elif b == -1:
                b = d // a
            if a * b != d:
                raise _base.MXNetError(
                    f"npx.reshape: cannot split dim of size {d} into "
                    f"({ns[j - 1]}, {ns[j]})")
            out.extend([a, b])
        else:
            raise _base.MXNetError(
                f"npx.reshape: unknown special value {s}")
        j += 1
    if infer_pos is not None:
        total = 1
        for d in in_shape:
            total *= d
        known = 1
        for d in out:
            if d != -1:
                known *= d
        out[infer_pos] = total // max(known, 1)
    return tuple(out)


def reshape(a, newshape, reverse=False, order="C"):
    """MXNet 2.x ``npx.reshape`` (not the legacy ``nd.reshape`` dialect:
    the special codes differ, see :func:`_npx_reshape_shape`)."""
    a_nd = _nd._as_nd(a)
    in_shape = tuple(a_nd.shape)
    if reverse:
        if any(int(s) == -6 for s in newshape):
            raise _base.MXNetError(
                "npx.reshape: reverse=True with -6 is not supported")
        shape = _npx_reshape_shape(in_shape[::-1],
                                   list(newshape)[::-1])[::-1]
    else:
        shape = _npx_reshape_shape(in_shape, newshape)
    return _nd.invoke("npx_reshape", lambda x: x.reshape(shape), [a_nd])


def nonzero(a):
    """The indices of the nonzero elements as an (N, ndim) int64 array
    (parity: npx.nonzero).  Eager only: its size is data-dependent, so
    it refuses to run inside a compiled program."""
    from ..utils.graphs import in_program
    if in_program():
        raise _base.MXNetError(
            "npx.nonzero has a data-dependent output shape and cannot run "
            "inside a compiled program (hybridize); call it eagerly")
    a_nd = _nd._as_nd(a)
    return NDArray(torch.nonzero(a_nd._t.detach()))


__all__ += ["save", "load", "waitall", "seed", "cpu", "gpu", "num_gpus",
            "current_device", "masked_softmax", "masked_log_softmax",
            "nonzero", "reshape"]
