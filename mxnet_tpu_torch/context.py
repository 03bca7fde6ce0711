"""Device model: ``cpu()`` and ``gpu(i)`` map to ``torch.device``
(counterpart of ``mxnet_tpu/context.py``).

The port's entry points run on the card.  :func:`resolve_device` turns
``device=None`` into the current CUDA device and raises when there is
none: a caller that wants the CPU says so with ``device="cpu"``, and
nothing falls back to it silently.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raises without one); a
    string or ``torch.device`` → itself, with a bare ``"cuda"`` pinned to
    an index so two spellings of one card compare equal."""
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available: pass device='cpu' to run "
                "on the CPU (the port never falls back to it silently)")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(f"device {dev} requested but CUDA is not "
                             "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
