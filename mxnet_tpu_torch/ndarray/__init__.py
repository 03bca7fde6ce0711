"""``mx.nd`` — the imperative NDArray API (counterpart of
``mxnet_tpu/ndarray/__init__.py``)."""
import torch as _torch

from . import ops
from .ndarray import (NDArray, arange, array, concatenate, empty, eye, full,
                      linspace, ones, zeros)
from .ops import *  # noqa: F401,F403
from .ops import invoke


def waitall():
    """Wait for all queued device work (``mx.nd.waitall``)."""
    if _torch.cuda.is_available() and _torch.cuda.is_initialized():
        _torch.cuda.synchronize()


def save(fname, data):
    """Write a dict of NDArrays (or tensors, numpy arrays) into an
    ``MXTPU1`` container either package reads."""
    from ..utils.serialization import save as _save
    if not isinstance(data, dict):
        raise TypeError("nd.save takes a dict of name -> NDArray")
    _save(fname, {k: v._t if isinstance(v, NDArray) else v
                  for k, v in data.items()})


def load(fname, ctx=None):
    """Read an ``MXTPU1`` container into a dict of NDArrays on ``ctx``
    (default: the current context)."""
    from ..utils.serialization import load as _load
    return {k: array(v, ctx=ctx) for k, v in _load(fname).items()}


def Custom(*data, op_type, **kwargs):
    """Invoke a registered Python custom op (``mx.nd.Custom``; see
    :mod:`mxnet_tpu_torch.operator`)."""
    from ..operator import Custom as _custom
    return _custom(*data, op_type=op_type, **kwargs)


def __getattr__(name):
    # mx.nd.contrib, mx.nd.sparse and mx.nd.cast_storage resolve at first
    # use, as the reference's do
    if name == "contrib":
        from .. import contrib
        globals()["contrib"] = contrib
        return contrib
    if name == "sparse":
        import importlib
        mod = importlib.import_module(".sparse", __name__)
        globals()["sparse"] = mod
        return mod
    if name == "cast_storage":
        from .sparse import cast_storage
        globals()["cast_storage"] = cast_storage
        return cast_storage
    raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no "
                         f"attribute {name!r}")
