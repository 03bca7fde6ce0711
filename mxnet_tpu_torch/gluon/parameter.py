"""Parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``).

A parameter is a plain ``torch.nn.Parameter``.  Until ``initialize`` (or
a load) gives it values it lives on the ``meta`` device: it has its
shape and dtype but no storage, which is the port's form of MXNet's
deferred initialization — a full-width model is built without touching
host memory, then materialized once, on its device.
"""
from __future__ import annotations

import torch

__all__ = ["new_parameter", "is_initialized"]


def new_parameter(shape, dtype=torch.float32) -> torch.nn.Parameter:
    """An uninitialized (meta-device) parameter of ``shape``/``dtype``."""
    return torch.nn.Parameter(
        torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                    device="meta"))


def is_initialized(p: torch.Tensor) -> bool:
    return p.device.type != "meta"
