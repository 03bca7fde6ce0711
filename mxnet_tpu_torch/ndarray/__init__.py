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
