"""Online serving (counterpart of ``mxnet_tpu.serving``), core only."""
from .batcher import BucketLattice, DynamicBatcher
from .engine import InferenceEngine, InferenceFuture
from .errors import (EngineStoppedError, InvalidRequestError, QueueFullError,
                     ServingError)

__all__ = ["InferenceEngine", "InferenceFuture", "BucketLattice",
           "DynamicBatcher", "ServingError", "QueueFullError",
           "EngineStoppedError", "InvalidRequestError"]
