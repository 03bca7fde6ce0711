"""Serving error taxonomy (counterpart of
``mxnet_tpu/serving/errors.py``): every failure a request can see is a
typed subclass of :class:`ServingError`."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "QueueFullError", "EngineStoppedError",
           "InvalidRequestError"]


class ServingError(MXNetError):
    """Base class for all online-inference failures."""


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is at its configured
    depth; the request was shed without being enqueued."""


class EngineStoppedError(ServingError):
    """The engine is stopped or stopping and will not finish this
    request."""


class InvalidRequestError(ServingError):
    """The request can never be served by this engine configuration
    (e.g. a prompt longer than the largest sequence bucket)."""
