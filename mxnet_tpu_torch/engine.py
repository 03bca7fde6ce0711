"""``mx.engine`` compatibility (counterpart of ``mxnet_tpu/engine.py``;
parity: python/mxnet/engine.py).

MXNet's threaded dependency engine is CUDA's stream order here, and
upstream's bulking of engine ops to cut per-op overhead is what a
hybridized block's CUDA graph does for its whole program: ``bulk()`` is
a context manager that only records the size, and ``set_bulk_size``
returns the previous value, as in the reference.  Kept so scripts using
these knobs run unchanged.
"""
from __future__ import annotations

import contextlib

__all__ = ["bulk", "set_bulk_size"]

_bulk_size = 15


def set_bulk_size(size: int) -> int:
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


@contextlib.contextmanager
def bulk(size: int):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
