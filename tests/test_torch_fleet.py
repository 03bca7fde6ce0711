"""The port's fleet against the JAX package's (``tests/test_fleet.py``,
``test_autoscaler.py`` and ``test_disagg.py``'s contracts).

The fleet is host Python in both packages; the port's copy runs over the
port's engines.  The policy's hash is the reference's bit for bit
(``rendezvous_hash``, ``rendezvous_rank`` and the affinity keys).  The
engines serve a tiny GPT-2 (vocab 61, 16 units, 1 layer, 2 heads, 32
positions, 2 layers where speculation or roles need them) with the
reference's weights copied across, and every greedy stream through a
router equals the reference's ``generate``: affinity with per-replica
compiles frozen after ``warmup()``, failover within the original
deadline, a replica killed mid-traffic (zero lost, re-admitted after
probation), a rolling restart, a drain that hangs (condemned, not
waited out), the fault sites ``fleet.route`` and ``fleet.failover``,
hedging, gray ejection, ``scale_up`` (warm before it joins) and
``scale_down`` (its prefix seeds hit on the survivor), the autoscaler's
hysteresis and its idle scale-down, and disaggregated placement through
``migrate_to`` / ``adopt``.  Timing is driven by fault plans and wide
bounds, as the reference's tests drive it.
"""
import threading
import time

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import fleet as jfleet
from mxnet_tpu_torch.fleet import (HEALTHY, SUSPECT, FleetAutoscaler,
                                   FleetDirectory, FleetRouter,
                                   ReplicaHandle, RoutingPolicy,
                                   rendezvous_hash, rendezvous_rank)
from mxnet_tpu_torch.resilience import FaultPlan
from mxnet_tpu_torch.serving import (EngineCrashedError, InferenceEngine,
                                     NoHealthyReplicaError, QueueFullError,
                                     RequestTimeoutError, ServingError)
from torch_ref_nets import gpt2_pair

CFG = dict(vocab_size=61, units=16, num_heads=2, max_length=32,
           dropout=0.0)


def _nets(layers):
    return gpt2_pair(num_layers=layers, **CFG)


@pytest.fixture(scope="module")
def nets():
    return _nets(1)


def _prompts(lens, seed=1, vocab=61):
    rs = onp.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).astype("int32") for n in lens]


def _family(n, shared_len=10, tail_len=3, seed=2, vocab=61):
    rs = onp.random.RandomState(seed)
    shared = rs.randint(0, vocab, (shared_len,)).astype("int32")
    return [onp.concatenate([shared, rs.randint(0, vocab, (tail_len,))
                             .astype("int32")]) for _ in range(n)]


def _factory(net, **kw):
    def factory(name):
        for k, v in dict(num_slots=2, max_batch=2, seq_buckets=(8,),
                         default_max_new_tokens=4, prefix_pool_rows=2,
                         prefix_min_tokens=2, watchdog_interval=0.05,
                         retry_backoff=0.001).items():
            kw.setdefault(k, v)
        return InferenceEngine(net, name=name, device="cpu", **kw)
    return factory


def _refs(jn, prompts, max_new):
    return [jn.generate(mx.nd.array(p[None], dtype="int32"), max_new,
                        temperature=0).asnumpy()[0] for p in prompts]


class _FakeEngine:
    """Just enough engine surface for the replica state machine."""

    def __init__(self, live=True):
        self.live = live

    def health(self):
        return {"live": self.live,
                "crashed": None if self.live else "test-induced"}


# ------------------------------------------------------------ the policy
def test_rendezvous_hash_and_affinity_keys_are_the_references():
    """The same blake2b scores, rankings and affinity keys as the
    reference, and the same bounded remap when the fleet grows."""
    names = [f"r{i}" for i in range(4)]
    keys = [f"key-{i}".encode() for i in range(300)]
    for k in keys[:50]:
        for n in names:
            assert rendezvous_hash(k, n) == jfleet.rendezvous_hash(k, n)
    for k in keys:
        assert rendezvous_rank(k, names) == jfleet.rendezvous_rank(k, names)
    moved = [k for k in keys if rendezvous_rank(k, names[:3])[0]
             != rendezvous_rank(k, names)[0]]
    assert all(rendezvous_rank(k, names)[0] == "r3" for k in moved)
    pol, jpol = RoutingPolicy(min_tokens=4, affinity_window=8), \
        jfleet.RoutingPolicy(min_tokens=4, affinity_window=8)
    for p in _family(4, shared_len=12, seed=5) + _prompts((3, 6, 9)):
        assert pol.affinity_key(p) == jpol.affinity_key(p)
    fam = _family(3, shared_len=12, seed=6)
    assert len({pol.affinity_key(p) for p in fam}) == 1


def test_directory_units():
    d = FleetDirectory(entries=2)
    d.publish(b"a", "r0")
    d.publish(b"b", "r1")
    d.publish(b"c", "r1")
    assert d.locate(b"a") is None and d.locate(b"c") == "r1"
    assert d.forget_replica("r1") == 2
    assert d.locate(b"b") is None and d.locate(b"c") is None
    assert d.stats() == {"entries": 0, "capacity": 2, "hits": 1,
                         "misses": 3, "evictions": 1, "hit_rate": 0.25}


# ------------------------------------------------------------ the router
def test_router_streams_and_per_replica_compile_freeze(nets):
    jn, tn = nets
    fams = _family(4, seed=11) + _family(4, seed=12) + \
        _prompts((3, 5, 7), seed=13)
    refs = _refs(jn, fams, 4)
    fleet = FleetRouter(factory=_factory(tn), num_replicas=3,
                        name="parity_fleet")
    warm = fleet.warmup()
    with fleet:
        outs = [f.result(timeout=120) for f in
                [fleet.submit(p, max_new_tokens=4) for p in fams]]
    for r, o in zip(refs, outs):
        onp.testing.assert_array_equal(r, o)
    s = fleet.stats()
    assert s["aggregate"]["completed"] == len(fams)
    for name, rep in s["replicas"].items():
        assert rep["stats"]["compile_cache"]["compiles"] == warm[name]
    assert s["router"]["affinity_routed"] + \
        s["router"].get("affinity_spills", 0) >= 8
    assert s["aggregate"]["prefix_hits"] >= 4


def test_saturation_spills_and_sheds_typed(nets):
    _, tn = nets
    fleet = FleetRouter(factory=_factory(tn, queue_depth=16),
                        num_replicas=2, name="spill_fleet",
                        spill_queue_depth=3)
    p = _family(1, shared_len=12, seed=9)[0]
    target = fleet._order_candidates(p)[0][0]
    for _ in range(3):
        target.engine.submit(p, max_new_tokens=2)
    order = fleet._order_candidates(p)[0]
    assert order[-1] is target and order[0] is not target
    assert fleet._counters["affinity_spills"] == 1
    for h in fleet._handles:
        h.engine.stop(drain=False)
    shed = FleetRouter(factory=_factory(tn, queue_depth=1), num_replicas=2,
                       name="shed_fleet")
    futs = [shed.submit(p, max_new_tokens=2) for _ in range(2)]
    with pytest.raises(QueueFullError):
        shed.submit(p, max_new_tokens=2)
    for h in shed._handles:
        h.engine.stop(drain=False)
    del futs


def test_failover_within_the_deadline_and_no_healthy_replica(nets):
    from mxnet_tpu_torch.fleet.router import _FleetRequest
    jn, tn = nets
    fleet = FleetRouter(factory=_factory(tn), num_replicas=2,
                        name="fo_fleet", max_failovers=1,
                        health_interval=10.0)
    fleet.start()
    try:
        p = _prompts((5,), seed=21)[0]
        ref = _refs(jn, [p], 4)[0]
        assert len(fleet.submit(p, max_new_tokens=4).result(60)) == 9
        served = [h for h in fleet._handles if h.routed > 0][0]
        served.engine.condemn("test-induced crash")
        onp.testing.assert_array_equal(
            ref, fleet.submit(p, max_new_tokens=4).result(60))
        req = _FleetRequest(p, "decode", 4, None, time.monotonic() - 1.0,
                            5)
        with pytest.raises(RequestTimeoutError):
            fleet._failover(req, ServingError("crashed"))
        with pytest.raises(ServingError, match="original crash"):
            fleet._failover(_FleetRequest(p, "decode", 4, None, None, 0),
                            ServingError("original crash"))
        for h in fleet._handles:
            h.engine.condemn("all gone")
        fleet.factory = None
        with pytest.raises(NoHealthyReplicaError):
            fleet.submit(p, max_new_tokens=2)
    finally:
        fleet.stop(timeout=30)


def test_a_replica_killed_mid_traffic_loses_nothing_and_returns(nets):
    jn, tn = nets
    fams = _family(8, seed=31)
    refs = _refs(jn, fams, 3)
    fleet = FleetRouter(factory=_factory(tn), num_replicas=2,
                        name="kill_fleet", probation=0.3,
                        health_interval=0.03)
    fleet.warmup()
    plan = FaultPlan().raise_at("serving.scheduler", at=4)
    with plan, fleet:
        outs = [f.result(timeout=120) for f in
                [fleet.submit(p, max_new_tokens=3) for p in fams]]
        for r, o in zip(refs, outs):
            onp.testing.assert_array_equal(r, o)
        assert fleet.stats()["router"].get("replica_deaths", 0) >= 1
        deadline = time.monotonic() + 30
        while len(fleet._healthy()) < 2:
            assert time.monotonic() < deadline, fleet.health()
            time.sleep(0.05)
        assert any(r["restarts"] >= 1
                   for r in fleet.health()["replicas"].values())
        for r, p in zip(refs, fams):
            onp.testing.assert_array_equal(
                r, fleet.infer(p, max_new_tokens=3))
    assert plan.fired("serving.scheduler") == 1


@pytest.mark.chaos
def test_rolling_restart_and_route_faults(nets):
    """A rolling restart cycles every replica while the fleet serves;
    faults at ``fleet.route`` degrade to least-loaded placement and a
    fault at ``fleet.failover`` surfaces the cause, spending nothing."""
    from mxnet_tpu_torch.fleet.router import _FleetRequest
    jn, tn = nets
    fams = _family(4, seed=41)
    refs = _refs(jn, fams, 3)
    fleet = FleetRouter(factory=_factory(tn), num_replicas=2,
                        name="roll_fleet")
    fleet.warmup()
    with fleet:
        with FaultPlan().raise_at("fleet.route", every=2):
            for p, r in zip(fams, refs):
                onp.testing.assert_array_equal(
                    r, fleet.infer(p, max_new_tokens=3))
        assert fleet.stats()["router"]["route_faults"] == 2
        fleet.rolling_restart(timeout=60)
        s = fleet.stats()
        assert all(rep["restarts"] == 1 for rep in s["replicas"].values())
        for name, rep in s["replicas"].items():
            assert rep["stats"]["engine"]["name"] == name
        for p, r in zip(fams, refs):
            onp.testing.assert_array_equal(
                r, fleet.infer(p, max_new_tokens=3))
        req = _FleetRequest(fams[0], "decode", 2, None, None, 5)
        with FaultPlan().raise_at("fleet.failover", at=1):
            with pytest.raises(ServingError, match="went away"):
                fleet._failover(req, ServingError("replica went away"))
        assert req.failovers_left == 5
        assert fleet.stats()["router"]["failover_faults"] == 1


@pytest.mark.chaos
def test_a_hung_drain_is_condemned_not_waited_out(nets):
    _, tn = nets
    fleet = FleetRouter(factory=_factory(tn), num_replicas=2,
                        name="wedge_fleet")
    fleet.warmup()
    plan = FaultPlan().delay_at("fleet.drain", 4.0, at=1)
    with plan:
        fleet.start()
        futs = [fleet.submit(p, max_new_tokens=3)
                for p in _prompts((4, 5, 6, 7), seed=71)]
        time.sleep(0.2)
        t0 = time.monotonic()
        fleet.stop(drain=True, timeout=1.0)
        elapsed = time.monotonic() - t0
    assert elapsed < 3.5, elapsed
    assert plan.fired("fleet.drain") == 1
    assert fleet.stats()["router"].get("forced_stops", 0) >= 1
    for f in futs:
        try:
            f.result(timeout=10)
        except (EngineCrashedError, ServingError):
            pass


def test_hedging_completes_on_the_second_replica(nets):
    jn, tn = nets
    p = _prompts((5,), seed=91)[0]
    fleet = FleetRouter(factory=_factory(tn), num_replicas=2,
                        name="hedge_fleet", hedge_after=0.15)
    fleet.warmup()
    with FaultPlan().delay_at("serving.prefill", 2.5, at=1), fleet:
        t0 = time.monotonic()
        out = fleet.infer(p, max_new_tokens=3)
        elapsed = time.monotonic() - t0
    onp.testing.assert_array_equal(_refs(jn, [p], 3)[0], out)
    assert elapsed < 2.0, elapsed
    assert fleet.stats()["router"].get("hedges", 0) == 1


def test_gray_ejection_ladder_and_two_replica_detector():
    from mxnet_tpu_torch.fleet.replica import DEAD
    h = ReplicaHandle("r0", _FakeEngine(), probation=0.5,
                      probation_backoff=2.0, probation_max=30.0)
    for s in (0.01, 0.02, 0.5):
        h.observe_latency(s)
    assert h.mark_suspect("slow", now=100.0)
    assert h.state == SUSPECT and not h.routable()
    assert h.suspect_until == 100.5
    assert not h.mark_suspect("again", now=100.1)
    assert h.due_for_unsuspect(now=100.6) and h.unsuspect()
    assert h.state == HEALTHY and h.latency.snapshot()["count"] == 0
    assert h.mark_suspect("still slow", now=200.0)
    assert h.suspect_until == 201.0
    h.engine.live = False
    assert h.probe(now=200.1) and h.state == DEAD
    r = FleetRouter.__new__(FleetRouter)
    r.gray_ejection, r.gray_multiplier, r.gray_min_samples = True, 4.0, 4
    r._counters, r._counters_lock = {}, threading.Lock()
    fast, slow = ReplicaHandle("r0", _FakeEngine()), \
        ReplicaHandle("r1", _FakeEngine())
    r._handles = [fast, slow]
    for _ in range(6):
        fast.observe_latency(0.01)
        slow.observe_latency(0.5)
    r._gray_check(now=100.0)
    assert slow.state == SUSPECT and fast.state == HEALTHY
    assert r._counters["gray_ejections"] == 1


@pytest.mark.chaos
def test_a_gray_replica_is_ejected_and_readmitted(nets):
    """A replica slowed by a per-replica delay plan goes SUSPECT (alive,
    unroutable), traffic keeps its tokens, and it is re-admitted without
    a rebuild once its ejection window passes."""
    jn, tn = nets
    fleet = FleetRouter(factory=_factory(tn), num_replicas=3,
                        name="gray", gray_multiplier=3.0,
                        gray_min_samples=3, health_interval=0.02,
                        probation=0.5)
    fleet.warmup()
    prompts = _prompts((4, 5, 6, 7, 5, 6, 4, 7, 5, 6, 4, 5), seed=101)
    refs = _refs(jn, prompts, 2)
    plan = FaultPlan().delay_at("serving.decode_step@gray-r1", 0.08,
                                every=1)
    with plan, fleet:
        for _ in range(3):
            for p, r in zip(prompts, refs):
                onp.testing.assert_array_equal(
                    r, fleet.infer(p, max_new_tokens=2))
            if fleet._by_name["gray-r1"].state == SUSPECT:
                break
        h = fleet._by_name["gray-r1"]
        assert h.total_suspects >= 1
        assert fleet.stats()["router"].get("gray_ejections", 0) >= 1
        deadline = time.monotonic() + 15
        while h.state != HEALTHY:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert h.restarts == 0


# ------------------------------------------------------ elastic fleet
def test_scale_up_warms_before_it_joins(nets):
    jn, tn = nets
    with FleetRouter(factory=_factory(tn), num_replicas=2,
                     name="up") as fleet:
        fleet.warmup()
        names = [h.name for h in fleet._handles]
        keys = [onp.random.RandomState(i).bytes(16) for i in range(64)]
        before = {k: rendezvous_rank(k, names)[0] for k in keys}
        new = fleet.scale_up(signals={"reason": "test"})
        assert new is not None and len(fleet._handles) == 3
        h = fleet._by_name[new]
        assert h.state == HEALTHY
        compiled = h.engine.stats()["compile_cache"]["compiles"]
        assert compiled > 0
        after = [x.name for x in fleet._handles]
        assert all(rendezvous_rank(k, after)[0] == new for k in keys
                   if rendezvous_rank(k, after)[0] != before[k])
        prompts = _family(4, seed=9)
        outs = [fleet.infer(p, max_new_tokens=4) for p in prompts]
        assert h.engine.stats()["compile_cache"]["compiles"] == compiled
        for a, b in zip(outs, _refs(jn, prompts, 4)):
            onp.testing.assert_array_equal(a, b)
    e = _factory(tn)("nofac")
    with FleetRouter(engines=[e], name="nofac-fleet") as fleet:
        with pytest.raises(ServingError):
            fleet.scale_up()
        with pytest.raises(ServingError):
            fleet.scale_down()


def test_scale_down_seeds_the_survivor(nets):
    jn, tn = nets
    with FleetRouter(factory=_factory(tn), num_replicas=2,
                     name="warm") as fleet:
        fleet.warmup()
        fam = _family(4, seed=6)
        futs = [fleet.submit(p, max_new_tokens=4) for p in fam]
        for f, r in zip(futs, _refs(jn, fam, 4)):
            onp.testing.assert_array_equal(f.result(60), r)
        holders = [h.name for h in fleet._handles
                   if h.engine._prefix is not None
                   and len(h.engine._prefix)]
        assert holders
        removed = fleet.scale_down(replica=holders[0])
        assert removed == holders[0] and len(fleet._handles) == 1
        assert fleet.stats()["router"].get("seeds_migrated", 0) > 0
        assert all(v != removed for v in fleet._directory._map.values())
        survivor = fleet._handles[0].engine
        before = survivor.metrics.counters.get("prefix_hits", 0)
        out = fleet.infer(fam[0], max_new_tokens=4)
        assert survivor.metrics.counters.get("prefix_hits", 0) > before
        onp.testing.assert_array_equal(out, _refs(jn, [fam[0]], 4)[0])


def test_autoscaler_hysteresis_and_idle_scale_down(nets):
    _, tn = nets
    with FleetRouter(factory=_factory(tn), num_replicas=2,
                     name="idle") as fleet:
        fleet.warmup()
        a = FleetAutoscaler(fleet, min_replicas=1, max_replicas=3,
                            queue_low=0, util_low=0.9, down_cycles=2,
                            down_cooldown=0.0)
        assert a.tick()["action"] == "hold"
        assert a.tick()["action"] == "down"
        assert len(fleet._handles) == 1
        a.tick()
        assert a.tick()["action"] == "hold" and len(fleet._handles) == 1
    with pytest.raises(ServingError):
        FleetAutoscaler(fleet, min_replicas=3, max_replicas=2)


# --------------------------------------------------- disaggregated fleet
def test_disaggregated_fleet_places_decode_by_the_prefill_key():
    """Prefill replicas hand every request to a decode replica chosen by
    the same affinity key; streams equal the reference's, and the decode
    replicas adopt them all."""
    jn, tn = _nets(2)
    base = dict(num_slots=2, max_batch=2, seq_buckets=(8, 16),
                default_max_new_tokens=4, kv_layout="paged", page_size=8,
                prefix_min_tokens=4)
    engines = [InferenceEngine(tn, role=role, name=f"dg-{role}{i}",
                               device="cpu", **base)
               for role in ("prefill", "decode") for i in range(2)]
    fleet = FleetRouter(engines=engines, name="dg")
    fleet.warmup()
    prompts = _family(3, seed=17) + _prompts((6, 11), seed=18)
    with fleet:
        outs = [fleet.infer(p, max_new_tokens=4) for p in prompts]
        s = fleet.stats()
    for o, r in zip(outs, _refs(jn, prompts, 4)):
        onp.testing.assert_array_equal(o, r)
    adopted = sum(rep["stats"]["migration"]["migrations_in"]
                  for rep in s["replicas"].values())
    assert adopted == len(prompts)
