"""Online serving (counterpart of ``mxnet_tpu.serving``): the reference's
exports but for KV tiers and migration (ROADMAP queue A7)."""
from .batcher import BucketLattice, DynamicBatcher
from .engine import InferenceEngine, InferenceFuture, Request
from .errors import (DeadlineExceededError, DeadlineInfeasibleError,
                     EngineCrashedError, EngineStoppedError,
                     FleetSaturatedError, InvalidRequestError,
                     MigrationDigestError, MigrationError,
                     NoHealthyReplicaError, NonFiniteOutputError,
                     QueueFullError, RequestCancelledError,
                     RequestTimeoutError, ServingError)
from .kv_pages import PagedPrefixCache, PagedPrefixEntry, PagePool
from .kv_slots import SlotAllocator, SlotState
from .metrics import LatencyHistogram, ServingMetrics
from .overload import (PRIORITIES, CircuitBreaker, OverloadController,
                       RetryBudget, priority_name, priority_ordinal)
from .prefix_cache import PrefixCache, PrefixEntry
from .sampling import sample_tokens

__all__ = [
    "InferenceEngine", "InferenceFuture", "Request",
    "BucketLattice", "DynamicBatcher",
    "SlotAllocator", "SlotState",
    "PagePool", "PagedPrefixCache", "PagedPrefixEntry",
    "PrefixCache", "PrefixEntry",
    "LatencyHistogram", "ServingMetrics",
    "sample_tokens",
    "PRIORITIES", "OverloadController", "RetryBudget", "CircuitBreaker",
    "priority_name", "priority_ordinal",
    "ServingError", "QueueFullError", "RequestTimeoutError",
    "DeadlineExceededError", "DeadlineInfeasibleError",
    "EngineStoppedError", "EngineCrashedError",
    "InvalidRequestError", "NonFiniteOutputError",
    "NoHealthyReplicaError", "RequestCancelledError",
    "FleetSaturatedError", "MigrationError", "MigrationDigestError",
]
