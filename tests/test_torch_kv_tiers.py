"""The port's tiered prefix cache against the JAX package's
(``tests/test_kv_tiers.py``'s contracts).

The unit half holds :class:`HostKVTier` and the paged cache's tier
plumbing to the reference's: a demoted bundle round-trips with its tail
scrubbed, a non-finite one is refused, the host pool is an LRU bounded
in bytes (spilling to disk, quarantining a rotted file), a rotted bundle
fails its verify, faults self-disable the tier, and a tier-2 claim is
downgraded, upgraded and never an LRU victim.

The engine half serves the same traffic through both packages' engines
(GPT-2 at vocab 97, 32 units, 2 layers, 4 heads, 64 positions, the
reference's weights copied across): streams are identical with the tier
on and off and to the reference's, the counts of demotions, promotions
and tier hits equal the reference's, the compiles stay frozen after
``warmup()``, a rotted bundle degrades to a recompute with a finite
pool, dirty pages never demote, and a tier disabled by faults keeps the
engine serving.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.resilience.faults import FaultPlan as JFaultPlan
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.resilience import FaultPlan
from mxnet_tpu_torch.serving import (HostKVTier, InferenceEngine,
                                     PagedPrefixCache, PagePool,
                                     ServingError)
from torch_ref_nets import gpt2_pair

CFG = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
           max_length=64, dropout=0.0)
COUNTS = ("tier_demotes", "tier_promotes", "tier_hits", "tier_misses",
          "tier_verify_failures", "tier_drops")


@pytest.fixture(scope="module")
def nets():
    return gpt2_pair(**CFG)


def _arrays(n_pages=2, ps=4, seed=0):
    rs = onp.random.RandomState(seed)
    return [torch.from_numpy(rs.rand(n_pages, ps, 2, 3).astype("float32"))
            for _ in range(4)]


def _tier(scope, pool_bytes=1 << 20, **kw):
    kw.setdefault("page_size", 4)
    return HostKVTier(pool_bytes, scope=scope, **kw).start()


def _nbytes(arrs):
    return sum(a.numel() * a.element_size() for a in arrs)


def _family(seed=3, shared=24, tails=3, tail=4):
    rs = onp.random.RandomState(seed)
    fam = rs.randint(0, 97, (shared,)).astype("int32")
    return [onp.concatenate([fam, rs.randint(0, 97, (tail,))
                             .astype("int32")]) for _ in range(tails)]


def _fillers(n, length=16, seed=200):
    return [onp.random.RandomState(seed + i).randint(0, 97, (length,))
            .astype("int32") for i in range(n)]


# --------------------------------------------------------- HostKVTier
def test_tier_roundtrip_scrubs_the_tail():
    t = _tier("u0")
    try:
        key, arrs = tuple(range(7)), _arrays(seed=1)
        assert t.offer(key, arrs, 7)
        t.drain()
        assert t.contains(key) and len(t) == 1
        h = t.request(key)
        t.drain()
        status, out = t.poll(h)
        assert status == "ready"
        for a, b in zip(arrs, out):
            a = a.numpy()
            onp.testing.assert_array_equal(a[0], b[0])
            onp.testing.assert_array_equal(a[1, :3], b[1, :3])
            assert onp.all(b[1, 3:] == 0)
        assert (t.counter("tier_demotes"), t.counter("tier_promotes"),
                t.counter("tier_verify_failures")) == (1, 1, 0)
    finally:
        t.stop()


def test_tier_refuses_a_nonfinite_bundle():
    t = _tier("u1")
    try:
        arrs = _arrays(seed=2)
        arrs[1][0, 1, 0, 0] = float("nan")
        assert t.offer((1, 2, 3, 4, 5), arrs, 5)
        t.drain()
        assert not t.contains((1, 2, 3, 4, 5)) and len(t) == 0
        assert t.counter("tier_drops") == 1
        assert t.counter("tier_faults") == 0
    finally:
        t.stop()


def test_tier_host_pool_is_a_bounded_lru():
    per = _nbytes(_arrays(seed=3))
    t = _tier("u2", pool_bytes=int(per * 2.5))
    try:
        for i in range(4):
            assert t.offer((100 + i,) * 5, _arrays(seed=10 + i), 7)
            t.drain()
        assert len(t) == 2 and t.used_bytes <= int(per * 2.5)
        assert not t.contains((100,) * 5) and not t.contains((101,) * 5)
        assert t.contains((102,) * 5) and t.contains((103,) * 5)
        assert t.counter("tier_evictions") == 2
        assert t.request((100,) * 5) is None
        assert t.counter("tier_misses") == 1
    finally:
        t.stop()


def test_tier_rot_fails_verify_and_is_forgotten():
    with FaultPlan().corrupt_at("serving.tier_rot", at=1):
        t = _tier("u3")
        try:
            key = tuple(range(8))
            assert t.offer(key, _arrays(seed=4), 8)
            t.drain()
            h = t.request(key)
            t.drain()
            assert t.poll(h) == ("failed", None)
            assert t.counter("tier_verify_failures") == 1
            assert t.counter("tier_misses") == 1
            assert not t.contains(key)
        finally:
            t.stop()


@pytest.mark.parametrize("site", ["serving.tier_demote",
                                  "serving.tier_promote"])
def test_tier_faults_are_contained(site):
    """Demote faults self-disable the tier at the fault limit; one
    promote fault fails that promotion only, and a clean one resets the
    streak."""
    plan = FaultPlan()
    if site == "serving.tier_demote":
        plan.raise_at(site, every=1)
    else:
        plan.raise_at(site, at=1)
    with plan:
        t = _tier("u4", fault_limit=3)
        try:
            if site == "serving.tier_demote":
                for i in range(5):
                    t.offer((i,) * 5, _arrays(seed=i), 7)
                    t.drain()
                assert not t.enabled and t.counter("tier_faults") == 3
                assert t.offer((99,) * 5, _arrays(seed=9), 7) is False
                assert t.request((0,) * 5) is None
                return
            key = tuple(range(6))
            assert t.offer(key, _arrays(seed=5), 6)
            t.drain()
            h = t.request(key)
            t.drain()
            assert t.poll(h) == ("failed", None)
            assert t.enabled and t.counter("tier_faults") == 1
            h2 = t.request(key)
            t.drain()
            assert t.poll(h2)[0] == "ready"
            assert t.snapshot()["fault_streak"] == 0
        finally:
            t.stop()


def test_tier_disk_spill_load_and_quarantine(tmp_path):
    per = _nbytes(_arrays(seed=6))
    t = HostKVTier(int(per * 1.5), page_size=4, scope="u6",
                   disk_dir=str(tmp_path)).start()
    try:
        for i in range(3):
            assert t.offer((50 + i,) * 5, _arrays(seed=20 + i), 7)
            t.drain()
        s = t.snapshot()
        assert s["entries"] == 1 and s["disk_entries"] == 2
        assert t.counter("tier_disk_spills") == 2
        h = t.request((50,) * 5)
        t.drain()
        assert t.poll(h)[0] == "ready"
        assert t.counter("tier_disk_loads") >= 1
        for p in os.listdir(tmp_path):
            if not p.startswith("corrupt-"):
                with open(tmp_path / p, "r+b") as f:
                    f.seek(30)
                    f.write(b"\xff" * 8)
        for j in range(3):
            hj = t.request((50 + j,) * 5)
            if hj is not None:
                t.drain()
                t.poll(hj)
        assert t.counter("tier_quarantines") >= 1
        assert any(p.startswith("corrupt-") for p in os.listdir(tmp_path))
    finally:
        t.stop()


def test_tier_validates_its_knobs():
    with pytest.raises(ServingError):
        HostKVTier(0, page_size=4)
    with pytest.raises(ServingError):
        HostKVTier(1 << 20, page_size=0)
    with pytest.raises(ServingError):
        InferenceEngine(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                        host_pool_bytes=-1, device="cpu")


def test_paged_cache_demotes_upgrades_and_never_evicts_a_claim():
    pool = PagePool(8, page_size=4)
    cache = PagedPrefixCache(pool, min_tokens=1)
    donor = pool.alloc(2)
    e = cache.insert(tuple(range(8)), donor, 8)
    pool.release(donor)
    hooked = []
    cache.demote_hook = lambda victim: (hooked.append(victim), True)[1]
    assert cache.evict_pages(2) == 2 and hooked == [e]
    assert e.tier == 2 and e.pages == () and len(cache) == 1
    assert cache.lookup(tuple(range(8)))[1] is e
    assert cache._lru_victim() is None
    fresh = pool.alloc(2)
    cache.upgrade(e, fresh, 8)
    assert e.tier == 1 and e.pages == tuple(fresh)
    assert all(pool.refs(p) == 2 for p in fresh)
    pool.release(fresh)
    with pytest.raises(ServingError):
        cache.upgrade(e, fresh)
    # a donor recomputing a demoted family re-backs the claim in place
    cache.demote_hook = lambda v: True
    cache.evict_pages(2)
    again = pool.alloc(2)
    assert cache.insert(tuple(range(8)), again, 8) is e and e.tier == 1
    # a pinned entry never demotes
    pool.release(again)
    calls = []
    cache.demote_hook = lambda v: (calls.append(v), True)[1]
    cache.pin(e)
    assert cache.evict_pages(2) == 0 and calls == []
    cache.unpin(e)
    assert cache.evict_pages(2) == 2 and calls == [e]


# ------------------------------------------------------------ engines
def _engine(pkg, net, name, **kw):
    for k, v in dict(num_slots=2, max_batch=2, seq_buckets=(8, 16, 32),
                     default_max_new_tokens=4, kv_layout="paged",
                     page_size=8, prefix_min_tokens=8,
                     host_pool_bytes=64 << 20).items():
        kw.setdefault(k, v)
    if pkg == "port":
        return InferenceEngine(net, name=name, device="cpu", **kw)
    return jserving.InferenceEngine(net, name=name, **kw)


def _traffic(eng, prompts, kwargs=None, drain_at=None):
    outs = []
    with eng:
        for i, p in enumerate(prompts):
            if drain_at is not None and i == drain_at and \
                    eng._tier is not None:
                eng._tier.drain()
            kw = dict(kwargs[i]) if kwargs else {}
            outs.append(onp.asarray(eng.infer(p, max_new_tokens=4, **kw)))
        if eng._tier is not None:
            eng._tier.drain()
        return outs, eng.stats()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tier_on_and_off_give_the_same_streams(nets, layout):
    """The reference's traffic, greedy and seeded: the port's streams
    with the tier on equal those with it off (a dense engine takes the
    knob and stays inert); greedy ones equal the reference's."""
    jn, tn = nets
    fam = _family(seed=13, tails=2)
    prompts = fam + _fillers(4, seed=300) + [fam[0], fam[1]]
    kwargs = [{} for _ in prompts]
    kwargs[1] = dict(temperature=0.8, seed=7)
    kwargs[-1] = dict(temperature=1.2, top_k=12, seed=11)
    outs = {}
    for pool_bytes in (0, 64 << 20):
        eng = _engine("port", tn, f"onoff{pool_bytes}", kv_layout=layout,
                      num_pages=12 if layout == "paged" else None,
                      host_pool_bytes=pool_bytes)
        eng.warmup()
        outs[pool_bytes] = _traffic(eng, prompts, kwargs, drain_at=6)[0]
    for off, on in zip(outs[0], outs[64 << 20]):
        onp.testing.assert_array_equal(off, on)
    for i, p in enumerate(prompts):
        if not kwargs[i]:
            onp.testing.assert_array_equal(
                outs[0][i], jn.generate(mx.nd.array(p[None], dtype="int32"),
                                        4, temperature=0).asnumpy()[0])


def test_demote_promote_counts_equal_the_reference(nets):
    """The headline path on both packages: the family's pages demote
    under filler traffic, its next members promote them back, the
    streams match, the tier's counts equal the reference's, and the
    compiles stay frozen after warmup (the install writes in place)."""
    jn, tn = nets
    fam = _family(seed=3, tails=3)
    prompts = [fam[0]] + _fillers(6) + fam[1:]
    got = {}
    for pkg, net in (("port", tn), ("ref", jn)):
        eng = _engine(pkg, net, f"rt_{pkg}", num_pages=12)
        n_warm = eng.warmup()
        outs, s = _traffic(eng, prompts, drain_at=7)
        assert s["compile_cache"]["compiles"] == n_warm
        assert s["requests"]["completed"] == len(prompts)
        got[pkg] = (outs, {k: s["tier"][k] for k in COUNTS},
                    s["prefix_cache"]["prefix_hits"])
    for a, b in zip(got["port"][0], got["ref"][0]):
        onp.testing.assert_array_equal(a, b)
    assert got["port"][1:] == got["ref"][1:]
    assert got["port"][1]["tier_demotes"] >= 1
    assert got["port"][1]["tier_promotes"] >= 1


def test_rot_degrades_to_recompute_with_a_finite_pool(nets):
    """Every bundle rots: each family re-hit recomputes (counted verify
    failures, no promotions), streams stay exact and the pool finite,
    as in the reference."""
    jn, tn = nets
    fam = _family(seed=5, tails=3)
    prompts = [fam[0]] + _fillers(6) + fam[1:]
    got = {}
    for pkg, net, plan in (("port", tn, FaultPlan()),
                           ("ref", jn, JFaultPlan())):
        plan.corrupt_at("serving.tier_rot", every=1)
        with plan:
            eng = _engine(pkg, net, f"rot_{pkg}", num_pages=12)
            eng.warmup()
            outs, s = _traffic(eng, prompts, drain_at=7)
        got[pkg] = (outs, {k: s["tier"][k] for k in COUNTS})
        if pkg == "port":
            for layer in eng._caches:
                for a in layer.values():
                    assert bool(torch.isfinite(a.float()).all())
    for a, b in zip(got["port"][0], got["ref"][0]):
        onp.testing.assert_array_equal(a, b)
    assert got["port"][1] == got["ref"][1]
    assert got["port"][1]["tier_verify_failures"] >= 1
    assert got["port"][1]["tier_promotes"] == 0


def test_dirty_pages_never_demote(nets):
    _, tn = nets
    eng = _engine("port", tn, "dirty", num_pages=12)
    eng.warmup()
    with eng:
        eng.infer(_family(seed=19, tails=1)[0])
        with eng._step_lock:
            for e in eng._prefix._entries:
                eng._pool.mark_dirty(e.pages)
        tainted = [tuple(int(t) for t in eng._entry_tokens(e))
                   for e in eng._prefix._entries]
        for p in _fillers(6, seed=500):
            eng.infer(p)
        eng._tier.drain()
        s = eng.stats()
        assert tainted
        for key in tainted:
            assert not eng._tier.contains(key)
    assert s["tier"]["tier_drops"] >= 1


def test_a_disabled_tier_keeps_the_engine_serving(nets):
    """A demote fault storm self-disables the tier at its limit; every
    request still completes with the reference's greedy tokens."""
    jn, tn = nets
    fam = _family(seed=23, tails=2)
    prompts = fam + _fillers(5, seed=600) + [fam[1]]
    with FaultPlan().raise_at("serving.tier_demote", every=1):
        eng = _engine("port", tn, "off", num_pages=12, tier_fault_limit=2)
        eng.warmup()
        outs, s = _traffic(eng, prompts)
    for o, p in zip(outs, prompts):
        onp.testing.assert_array_equal(
            o, jn.generate(mx.nd.array(p[None], dtype="int32"), 4,
                           temperature=0).asnumpy()[0])
    assert s["tier"]["enabled"] is False
    assert s["tier"]["tier_faults"] == 2
    assert s["tier"]["store"]["disabled"] is True
    assert s["requests"]["completed"] == len(prompts)
