"""Foundational pieces (counterpart of ``mxnet_tpu/base.py``): the
framework error type, the name → class registries, the thread-local
training-mode and recording flags, and the ambient auxiliary-loss
collector."""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["MXNetError", "numeric_types", "integer_types", "string_types",
           "registry", "is_training", "set_training",
           "training_mode", "is_recording", "set_recording", "torch_dtype",
           "aux_collection_active", "set_aux_collection", "record_aux_loss",
           "pop_aux_losses"]


class MXNetError(RuntimeError):
    """Framework-level error (parity with mxnet.base.MXNetError)."""


# MXNet's type tuples (``mxnet.base``)
numeric_types = (float, int, np.generic, np.ndarray)
integer_types = (int, np.integer)
string_types = (str,)


_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from an MXNet dtype name, a numpy dtype or a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


class _Registry:
    """Name → object registry (optimizers, later initializers and
    metrics); keys are lower-cased."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None, obj: Any = None):
        """``register(name, obj)``, or ``@register()`` / ``@register(name)``
        as a decorator (default key: the object's ``__name__``)."""
        def _do(o):
            key = (name or getattr(o, "__name__", None) or str(o)).lower()
            self._entries[key] = o
            return o

        return _do(obj) if obj is not None else _do

    def get(self, name: str):
        try:
            return self._entries[name.lower()]
        except KeyError:
            raise MXNetError(f"Unknown {self.kind} '{name}'. Registered: "
                             f"{sorted(self._entries)}") from None


_REGISTRIES: Dict[str, _Registry] = {}


def registry(kind: str) -> _Registry:
    """The process-wide registry of ``kind``, created on first use."""
    if kind not in _REGISTRIES:
        _REGISTRIES[kind] = _Registry(kind)
    return _REGISTRIES[kind]


_STATE = threading.local()


def is_training() -> bool:
    """Whether layers run in training mode (dropout active) on this
    thread.  Off by default, as in MXNet outside ``autograd.record``."""
    return getattr(_STATE, "train_mode", False)


def set_training(flag: bool) -> bool:
    prev = is_training()
    _STATE.train_mode = bool(flag)
    return prev


@contextlib.contextmanager
def training_mode(flag: bool):
    prev = set_training(flag)
    try:
        yield
    finally:
        set_training(prev)


def is_recording() -> bool:
    """Whether ``autograd.record`` is active on this thread: NDArray ops
    and NDArray calls into a Block build a graph only then."""
    return getattr(_STATE, "recording", False)


def set_recording(flag: bool) -> bool:
    prev = is_recording()
    _STATE.recording = bool(flag)
    return prev


# The ambient auxiliary-loss collector (``base.py:190-217``): layers such
# as the MoE router append their losses during the forward, and the loss
# function of the same (micro)batch drains them.  A layer records only
# while ``autograd.record()`` or an aux-collection scope is open, so a
# forward nobody drains (inference, serving) leaves nothing behind.

def aux_collection_active() -> bool:
    return getattr(_STATE, "aux_collect", False)


def set_aux_collection(flag: bool) -> bool:
    prev = aux_collection_active()
    _STATE.aux_collect = bool(flag)
    return prev


def record_aux_loss(x) -> None:
    if not hasattr(_STATE, "aux_losses"):
        _STATE.aux_losses = []
    _STATE.aux_losses.append(x)


def pop_aux_losses() -> list:
    """Drain and return this thread's recorded aux losses."""
    out = list(getattr(_STATE, "aux_losses", ()))
    _STATE.aux_losses = []
    return out
