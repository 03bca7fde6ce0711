"""Foundational pieces the serving slice uses: the framework error type
and the training-mode flag (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["MXNetError", "is_training", "set_training", "training_mode",
           "torch_dtype"]


class MXNetError(RuntimeError):
    """Framework-level error (parity with mxnet.base.MXNetError)."""


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A floating ``torch.dtype`` from an MXNet dtype name or a torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


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
