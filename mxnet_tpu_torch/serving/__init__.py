"""Online serving (counterpart of ``mxnet_tpu.serving``): the reference's
exports, disaggregated prefill/decode with KV migration and the tiered
prefix cache included (``request_key`` aside: the port's sampler seeds
a Philox hash, not a key)."""
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
from .migration import (MIGRATION_SCHEMA_VERSION, MigrationBundle,
                        bundle_digest, export_bundle, verify_bundle)
from .kv_slots import SlotAllocator, SlotState
from .kv_tiers import HostKVTier, TierHandle
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
    "HostKVTier", "TierHandle",
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
    "MigrationBundle", "MIGRATION_SCHEMA_VERSION",
    "export_bundle", "bundle_digest", "verify_bundle",
]
