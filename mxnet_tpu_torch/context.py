"""Device model (counterpart of ``mxnet_tpu/context.py``): ``cpu()`` and
``gpu(i)`` are :class:`Context` handles over a ``torch.device``, and each
is a scope, ``with mx.cpu(): ...``, as in MXNet.

The port's entry points run on the card.  :func:`resolve_device` turns
``device=None`` into the innermost scope's device, and outside any scope
into the current CUDA device, raising when there is none: a caller that
wants the CPU says so (``device="cpu"``, ``ctx=mx.cpu()`` or a
``with mx.cpu():`` scope), and nothing falls back to it silently.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "Device", "cpu", "gpu", "cpu_pinned", "num_gpus",
           "current_context", "current_device", "resolve_device"]

_SCOPES = threading.local()


class Context:
    """A device handle, ``Context('gpu', 0)``; entering it makes it the
    default device of this thread until the scope ends."""

    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}
    devid2type = {v: k for k, v in devtype2id.items()}

    def __init__(self, device_type="cpu", device_id: int = 0):
        if isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = "gpu" if device_type.type == "cuda" else \
                device_type.type
        if device_type not in self.devtype2id:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        if self.device_type != "gpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def empty_cache(self):
        """Give the caching allocator's free blocks on this card back to
        the driver (MXNet's ``ctx.empty_cache()``); a no-op on the CPU."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        if not hasattr(_SCOPES, "stack"):
            _SCOPES.stack = []
        _SCOPES.stack.append(self)
        return self

    def __exit__(self, *exc):
        _SCOPES.stack.pop()
        return False


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Host memory the card copies from without staging: arrays made on
    it are page-locked when a card is present."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA devices, so ``mx.gpu() if mx.context.num_gpus()
    else mx.cpu()`` picks the card."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


Device = Context  # MXNet 2.x's name


def _scope():
    stack = getattr(_SCOPES, "stack", None)
    return stack[-1] if stack else None


def current_context() -> Context:
    """The innermost ``with ctx:`` scope's context, else the current CUDA
    device (raises without one)."""
    return _scope() or Context(resolve_device(None))


current_device = current_context


def resolve_device(device=None) -> torch.device:
    """``None`` → the innermost scope's device, else the current CUDA
    device (raises without one); a :class:`Context`, string or
    ``torch.device`` → itself, with a bare ``"cuda"`` pinned to an index
    so two spellings of one card compare equal."""
    if device is None:
        scope = _scope()
        if scope is not None:
            return resolve_device(scope)
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available: pass device='cpu' (or "
                "ctx=mx.cpu(), or run inside `with mx.cpu():`) to run on "
                "the CPU (the port never falls back to it silently)")
        return torch.device("cuda", torch.cuda.current_device())
    dev = device.torch_device if isinstance(device, Context) else \
        torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(f"device {dev} requested but CUDA is not "
                             "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
