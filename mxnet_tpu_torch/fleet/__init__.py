"""``mxnet_tpu_torch.fleet`` — the multi-replica serving tier.

Counterpart of ``mxnet_tpu/fleet/__init__.py``: the same names, options,
counters, lock sites and fault sites, over the port's engines.

"Millions of users" means N engines, not one (ROADMAP item 2): a
:class:`FleetRouter` fronts N :class:`~mxnet_tpu_torch.serving.
InferenceEngine` replicas behind the single engine's ``infer`` /
``submit`` / ``stats`` / ``stop`` surface, adding prefix-affinity
placement (rendezvous-hash the shared prompt prefix so a prompt
family's requests land on the replica that already caches it —
multiplying the single-engine prefix-cache TTFT win across the fleet),
health-gated load balancing with probation/backoff re-admission,
gray-failure ejection (a replica that answers ``health()`` but serves
far slower than its peers' median goes ``SUSPECT`` — unroutable but
alive, re-admitted without a rebuild; docs/integrity.md), bounded
failover of crash-failed requests within the original deadline, and
rolling drain/restart for zero-downtime upgrades.  See docs/fleet.md.

Quick start::

    def factory(name):
        return InferenceEngine(net, num_slots=8, prefix_pool_rows=4,
                               name=name)

    with FleetRouter(factory=factory, num_replicas=3) as fleet:
        fleet.warmup()
        futs = [fleet.submit(p, max_new_tokens=32) for p in prompts]
        outs = [f.result() for f in futs]
        print(fleet.stats()["aggregate"]["prefix_hit_rate"])
"""
from ..serving.errors import FleetSaturatedError, NoHealthyReplicaError
from ..serving.overload import CircuitBreaker, RetryBudget
from .autoscaler import FleetAutoscaler
from .directory import FleetDirectory
from .policy import RoutingPolicy, rendezvous_hash, rendezvous_rank
from .replica import (DEAD, DRAINING, HEALTHY, STOPPED, SUSPECT,
                      ReplicaHandle)
from .router import FleetFuture, FleetRouter

__all__ = [
    "FleetRouter", "FleetFuture", "ReplicaHandle", "RoutingPolicy",
    "FleetDirectory", "FleetAutoscaler",
    "rendezvous_hash", "rendezvous_rank",
    "NoHealthyReplicaError", "FleetSaturatedError",
    "RetryBudget", "CircuitBreaker",
    "HEALTHY", "DEAD", "DRAINING", "STOPPED", "SUSPECT",
]
