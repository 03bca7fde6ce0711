"""``mxnet_tpu_torch.resilience`` — fault injection, preemption-safe
training, and the liveness machinery behind the hardened serving engine
(counterpart of ``mxnet_tpu/resilience/``).

Three coupled layers (docs/resilience.md has the cookbook):

1. :mod:`~mxnet_tpu_torch.resilience.faults` — a seeded, context-scoped
   :class:`FaultPlan` whose injection sites are threaded through the hot
   paths (``ShardedTrainer.step`` and its poison splice, checkpoint
   save/restore, the atomic serialization commit; the serving, kvstore
   and fleet sites are declared for their callers to come).  Zero-cost
   when disabled.
2. :class:`ResilientLoop` + :class:`AtomicCheckpointer` — training that
   a kill at any instant cannot corrupt and a fresh process resumes
   deterministically (same data offset, same per-step RNG).
3. :class:`Watchdog` — the generic dead/hung-thread detector the serving
   engine uses to fail stranded requests with ``EngineCrashedError``
   instead of hanging callers.
4. :mod:`~mxnet_tpu_torch.resilience.integrity` — end-to-end state integrity
   (docs/integrity.md): per-file BLAKE2b checkpoint manifests with
   verify → quarantine → fallback-chain restore
   (:class:`CheckpointCorruptError` when nothing intact remains), and
   the :class:`LatencyTracker` behind the fleet's gray-failure
   (SUSPECT) ejection.

The faults layer is imported eagerly (hot paths need ``inject`` at
module import); the heavier layers load lazily.
"""
from .faults import (FaultPlan, FaultSpec, InjectedFault, RetryableFault,
                     SimulatedPreemption, active_plan, inject, poison)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "RetryableFault",
    "SimulatedPreemption", "active_plan", "inject", "poison",
    "AtomicCheckpointer", "ResilientLoop", "NonFiniteStepError",
    "Watchdog", "CheckpointCorruptError", "LatencyTracker",
    "verify_step_dir", "write_manifest",
]

_LAZY = {
    "AtomicCheckpointer": ".checkpoint",
    "ResilientLoop": ".loop",
    "NonFiniteStepError": ".loop",
    "Watchdog": ".watchdog",
    "CheckpointCorruptError": ".integrity",
    "LatencyTracker": ".integrity",
    "verify_step_dir": ".integrity",
    "write_manifest": ".integrity",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name], __name__)
        obj = getattr(mod, name)
        globals()[name] = obj
        return obj
    raise AttributeError(
        f"module 'mxnet_tpu_torch.resilience' has no attribute {name!r}")
