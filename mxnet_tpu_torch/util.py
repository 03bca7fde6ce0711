"""Miscellaneous user-facing utilities (counterpart of
``mxnet_tpu/util.py``; parity: python/mxnet/util.py).

The np-state functions delegate to :mod:`.numpy_extension`.
``disable_jit`` / ``enable_jit`` turn hybridize's compiled programs off
and on for the process: while off, a hybridized block runs its forward
imperatively, op by op, as the reference's jitted calls do under
``jax_disable_jit`` (``MXNET_ENGINE_TYPE=NaiveEngine`` at import turns
them off too).
"""
from __future__ import annotations

import os

from .utils import graphs as _graphs

__all__ = ["is_np_array", "is_np_shape", "set_np", "reset_np", "use_np",
           "np_array", "np_shape", "get_gpu_count", "get_gpu_memory",
           "getenv", "setenv", "default_array", "disable_jit",
           "enable_jit"]


class _JitOffScope:
    def __init__(self, prior: bool):
        self._prior = prior

    def __enter__(self):
        return self

    def __exit__(self, *a):
        # the prior setting comes back (a NaiveEngine process stays off)
        _graphs.set_compile(self._prior)
        return False


def disable_jit():
    """Run hybridized blocks imperatively, op by op: the first switch to
    flip when isolating a capture or scheduling fault.  Acts at once;
    use as a context manager to restore the prior setting on exit, or
    call :func:`enable_jit` later::

        with mx.util.disable_jit():
            net(x)      # eager, debuggable
    """
    return _JitOffScope(_graphs.set_compile(False))


def enable_jit():
    """Undo a :func:`disable_jit` not used as a context manager (also
    one set by ``MXNET_ENGINE_TYPE=NaiveEngine``)."""
    _graphs.set_compile(True)


def _npx():
    from . import numpy_extension as npx
    return npx


def is_np_array():
    return _npx().is_np_array()


def is_np_shape():
    return _npx().is_np_shape()


def set_np(shape=True, array=True, dtype=False):
    return _npx().set_np(shape, array, dtype)


def reset_np():
    return _npx().reset_np()


def use_np(fn=None):
    return _npx().use_np(fn)


def np_array(active=True):
    return _npx().np_array(active)


def np_shape(active=True):
    return _npx().np_shape(active)


def get_gpu_count():
    from .context import num_gpus
    return num_gpus()


def get_gpu_memory(dev_id=0):
    """(bytes allocated by this process, the card's total bytes) of card
    ``dev_id``; (0, 0) without one."""
    import torch
    if not torch.cuda.is_available() or \
            dev_id >= torch.cuda.device_count():
        return (0, 0)
    return (torch.cuda.memory_allocated(dev_id),
            torch.cuda.get_device_properties(dev_id).total_memory)


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value


def default_array(source_array, ctx=None, dtype=None):
    """An array in the default (np or legacy nd) API style."""
    if is_np_array():
        from . import numpy as np
        return np.array(source_array, dtype=dtype, ctx=ctx)
    from . import ndarray as nd
    return nd.array(source_array, ctx=ctx, dtype=dtype)
