"""The port's disaggregated serving against the JAX package's
(``tests/test_disagg.py``'s contracts).

Both packages serve GPT-2 at vocab 97, 32 units, 2 layers, 4 heads and
64 positions with the reference's weights copied across.  A bundle or a
prefix seed is built by one package and checked in the other:

- the digests of the same bundle and seed are equal in both packages
  (one BLAKE2b tree digest over the same header and leaf bytes);
- a decode engine of either package adopts the other's bundle (dense,
  paged float32, paged int8) and continues it greedily token-identically
  to the exporting package's colocated engine (the reference's bundle is
  decoded by the port; the port's by the reference);
- a seed either package exports plants in the other's engine and the
  family's next member hits it, greedy streams unchanged;
- the refusal matrix (digest first, then layout, page size, storage arm,
  capacity) is typed in both packages and leaves the pool as it was;
- the port's own prefill-role engine hands off to its decode-role engine
  with streams equal to a unified engine (greedy and sampled), the
  compiles frozen after ``warmup()`` on both roles, and a fault at
  ``serving.migrate_out`` or ``serving.migrate_in`` serves the request
  where it was prefilled.
"""
import threading
import time

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch.resilience import FaultPlan
from mxnet_tpu_torch.serving import (InferenceEngine, MigrationBundle,
                                     MigrationDigestError, MigrationError,
                                     ServingError, bundle_digest)
from mxnet_tpu_torch.serving.migration import PrefixSeed, seed_digest
from torch_ref_nets import gpt2_pair

CFG = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
           max_length=64, dropout=0.0)
ENG = dict(num_slots=2, max_batch=2, seq_buckets=(8, 16),
           default_max_new_tokens=6)
ARMS = {"dense": {}, "paged": dict(kv_layout="paged", page_size=8),
        "int8": dict(kv_layout="paged", page_size=8, kv_quant="int8")}
MAX_NEW = 6


@pytest.fixture(scope="module")
def nets():
    return gpt2_pair(**CFG)


def _prompts(lens=(5, 11, 14), seed=1):
    rs = onp.random.RandomState(seed)
    return [rs.randint(0, 97, (n,)).astype("int32") for n in lens]


def _family(n=2, shared=20, tail=3, seed=2):
    rs = onp.random.RandomState(seed)
    fam = rs.randint(0, 97, (shared,)).astype("int32")
    return [onp.concatenate([fam, rs.randint(0, 97, (tail,))
                             .astype("int32")]) for _ in range(n)]


# request i: seeded i, odd i sampled
def _samp(i):
    return dict(seed=i, temperature=0.7 if i % 2 else 0.0)


def _capture(into):
    """A migration target that keeps the bundle and refuses it, so the
    prefill engine serves the request itself: its stream is the
    colocated one the adopting engine must continue."""
    def target(bundle, future):
        into.append(bundle)
        raise MigrationError("captured")
    return target


def _serve(eng, prompts, max_new=MAX_NEW):
    futs = [eng.submit(p, max_new_tokens=max_new, **_samp(i))
            for i, p in enumerate(prompts)]
    return [onp.asarray(f.result(timeout=120)) for f in futs]


@pytest.fixture(scope="module")
def ref_bundles(nets):
    """Per arm: the reference's bundles (captured off its prefill-role
    engine) and the streams it served colocated."""
    jn, _ = nets
    out = {}
    for arm, kw in ARMS.items():
        got = []
        eng = jserving.InferenceEngine(jn, role="prefill", name=f"jp_{arm}",
                                       **ENG, **kw)
        eng.migrate_to(_capture(got))
        eng.warmup()
        with eng:
            streams = _serve(eng, _prompts())
        out[arm] = (got, streams)
    return out


@pytest.fixture(scope="module")
def port_bundles(nets):
    _, tn = nets
    out = {}
    for arm, kw in ARMS.items():
        got = []
        eng = InferenceEngine(tn, role="prefill", name=f"tp_{arm}",
                              device="cpu", **ENG, **kw)
        eng.migrate_to(_capture(got))
        eng.warmup()
        with eng:
            streams = _serve(eng, _prompts())
        out[arm] = (got, streams)
    return out


def _as_port(b):
    """The reference's bundle as the port's class, field by field."""
    p = MigrationBundle(
        source=b.source, layout=b.layout, page_size=b.page_size,
        prompt=b.prompt, first_token=b.first_token,
        max_new_tokens=b.max_new_tokens, eos_id=b.eos_id,
        deadline=b.deadline, priority=b.priority,
        temperature=b.temperature, top_k=b.top_k, top_p=b.top_p,
        seed=b.seed, n_pages=b.n_pages,
        arrays=[onp.asarray(a) for a in b.arrays], trace_id=b.trace_id,
        route_hint=b.route_hint, kv_quant=b.kv_quant)
    p.digest = b.digest
    return p


def _as_ref(b):
    from mxnet_tpu.serving.migration import MigrationBundle as J
    p = J(source=b.source, layout=b.layout, page_size=b.page_size,
          prompt=b.prompt, first_token=b.first_token,
          max_new_tokens=b.max_new_tokens, eos_id=b.eos_id,
          deadline=b.deadline, priority=b.priority,
          temperature=b.temperature, top_k=b.top_k, top_p=b.top_p,
          seed=b.seed, n_pages=b.n_pages, arrays=list(b.arrays),
          trace_id=b.trace_id, route_hint=b.route_hint,
          kv_quant=b.kv_quant)
    p.digest = b.digest
    return p


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_bundle_digests_equal_in_both_packages(ref_bundles, port_bundles,
                                               arm):
    """The reference's bundles hash to their digest in the port, the
    port's to theirs in the reference, and the leaves have the
    reference's order, shapes and dtypes."""
    from mxnet_tpu.serving.migration import bundle_digest as jdigest
    refs, ports = ref_bundles[arm][0], port_bundles[arm][0]
    assert len(refs) == len(ports) == 3
    for i, (jb, tb) in enumerate(zip(refs, ports)):
        assert bundle_digest(jb) == jb.digest
        assert bundle_digest(_as_port(jb)) == jb.digest
        assert jdigest(tb) == tb.digest
        assert [(a.shape, a.dtype) for a in tb.arrays] == \
            [(onp.asarray(a).shape, onp.asarray(a).dtype)
             for a in jb.arrays]
        assert (tb.n_pages, tb.prompt_len) == (jb.n_pages, jb.prompt_len)
        if not _samp(i)["temperature"]:
            assert tb.first_token == jb.first_token


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_port_decode_engine_continues_the_references_bundles(
        nets, ref_bundles, port_bundles, arm):
    """The port adopts the reference's bundles: greedy streams equal the
    reference's colocated ones; a sampled one keeps the reference's first
    token and then draws the port's own noise (a Philox hash of seed and
    position, not jax's keys); the compiles stay frozen after warmup."""
    _, tn = nets
    bundles, jstreams = ref_bundles[arm]
    tstreams = port_bundles[arm][1]
    eng = InferenceEngine(tn, role="decode", name=f"td_{arm}",
                          device="cpu", **ENG, **ARMS[arm])
    n_warm = eng.warmup()
    with eng:
        outs = [onp.asarray(eng.adopt(_as_port(b)).result(timeout=120))
                for b in bundles]
        s = eng.stats()
    for i, (o, b) in enumerate(zip(outs, bundles)):
        if _samp(i)["temperature"]:
            assert o.shape == tstreams[i].shape
            assert o[b.prompt_len] == b.first_token
        else:
            onp.testing.assert_array_equal(o, jstreams[i])
    assert s["migration"]["migrations_in"] == 3
    assert s["compile_cache"]["compiles"] == n_warm


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_reference_decode_engine_continues_the_ports_bundles(
        nets, port_bundles, ref_bundles, arm):
    """The reverse: the reference adopts the port's bundles, and its
    greedy continuations equal the port's colocated streams."""
    jn, _ = nets
    bundles, tstreams = port_bundles[arm]
    eng = jserving.InferenceEngine(jn, role="decode", name=f"jd_{arm}",
                                   **ENG, **ARMS[arm])
    with eng:
        outs = [onp.asarray(eng.adopt(_as_ref(b)).result(timeout=120))
                for b in bundles]
    for i, o in enumerate(outs):
        if not _samp(i)["temperature"]:
            onp.testing.assert_array_equal(o, tstreams[i])
    assert eng.stats()["migration"]["migrations_in"] == 3


def _seeds(eng, prompts):
    with eng:
        for p in prompts:
            eng.infer(p, max_new_tokens=2)
        return eng.export_prefix_seeds()


@pytest.mark.parametrize("arm", ["dense", "paged", "int8"])
def test_seeds_cross_the_packages_and_hit(nets, arm):
    """Seeds the reference exports plant in the port's engine (and the
    port's in the reference's): equal digests in both packages, and the
    family's next member is a prefix hit with the unseeded stream."""
    from mxnet_tpu.serving.migration import seed_digest as jdigest
    jn, tn = nets
    kw = dict(ARMS[arm])
    if arm == "dense":
        kw["prefix_pool_rows"] = 2
    fam = _family(3)
    jseeds = _seeds(jserving.InferenceEngine(jn, name=f"js_{arm}", **ENG,
                                             **kw), fam[:1])
    tseeds = _seeds(InferenceEngine(tn, name=f"ts_{arm}", device="cpu",
                                    **ENG, **kw), fam[:1])
    assert len(jseeds) == len(tseeds) == 1
    js, ts = jseeds[0], tseeds[0]
    assert seed_digest(js) == js.digest and jdigest(ts) == ts.digest
    assert [(a.shape, a.dtype) for a in ts.arrays] == \
        [(onp.asarray(a).shape, onp.asarray(a).dtype) for a in js.arrays]
    # the reference's seed into the port
    seed = PrefixSeed(source=js.source, layout=js.layout,
                      page_size=js.page_size, tokens=js.tokens,
                      length=js.length,
                      arrays=[onp.asarray(a) for a in js.arrays],
                      kv_quant=js.kv_quant)
    seed.digest = js.digest
    eng = InferenceEngine(tn, name=f"tz_{arm}", device="cpu", **ENG, **kw)
    assert eng.seed_prefix(seed)
    assert not eng.seed_prefix(seed)          # already cached
    with eng:
        got = eng.infer(fam[1], max_new_tokens=4)
    assert eng.stats()["prefix_cache"]["prefix_hits"] == 1
    want = jn.generate(mx.nd.array(fam[1][None], dtype="int32"), 4,
                       temperature=0).asnumpy()[0]
    onp.testing.assert_array_equal(got, want)
    # and the port's into the reference
    jeng = jserving.InferenceEngine(jn, name=f"jz_{arm}", **ENG, **kw)
    assert jeng.seed_prefix(ts)
    with jeng:
        onp.testing.assert_array_equal(
            jeng.infer(fam[2], max_new_tokens=4),
            jn.generate(mx.nd.array(fam[2][None], dtype="int32"), 4,
                        temperature=0).asnumpy()[0])
    assert jeng.stats()["prefix_cache"]["prefix_hits"] == 1


def _pool_state(eng):
    pool = eng._pool
    return None if pool is None else (pool.free_count, eng._alloc.free_count)


@pytest.mark.parametrize("case", ["digest", "layout", "page_size",
                                  "kv_quant", "capacity"])
def test_refusals_are_typed_in_both_packages(nets, ref_bundles, case):
    """Digest first, then layout, page size, storage arm and capacity:
    the same refusal class in both packages, and neither pool moves."""
    jn, tn = nets
    b = ref_bundles["paged"][0][1]
    kw = dict(ARMS["paged"])
    want = MigrationError
    if case == "digest":
        b = _as_port(b)
        b.arrays = [a.copy() for a in b.arrays]
        b.arrays[0].reshape(-1)[3] += 1.0
        want = MigrationDigestError
        kw = dict(ARMS["dense"])       # the digest is checked first
    elif case == "layout":
        kw = dict(ARMS["dense"])
    elif case == "page_size":
        kw = dict(kv_layout="paged", page_size=4)
    elif case == "kv_quant":
        kw = dict(ARMS["int8"])
    else:
        kw["max_length"] = 16
        kw["seq_buckets"] = (8, 16)
    for make, conv in ((lambda: InferenceEngine(
            tn, role="decode", name=f"tr_{case}", device="cpu",
            **dict(ENG, **kw)), _as_port),
            (lambda: jserving.InferenceEngine(
                jn, role="decode", name=f"jr_{case}",
                **dict(ENG, **kw)), _as_ref)):
        eng = make()
        before = _pool_state(eng)
        errs = (jserving.MigrationDigestError if want is
                MigrationDigestError else jserving.MigrationError, want)
        with pytest.raises(errs):
            eng.adopt(conv(b))
        assert _pool_state(eng) == before
        eng.stop(drain=False)


def test_port_prefill_hands_off_to_port_decode(nets, port_bundles):
    """A prefill-role engine with ``migrate_to(decode.adopt)``: every
    request migrates, the streams equal a unified engine's (greedy and
    sampled), both roles' compiles stay frozen, and the counters say
    so.  Two requests: the decode engine's two slots take both, so
    none is refused for capacity (a third would race their decode)."""
    _, tn = nets
    prompts = _prompts()[:2]
    want = port_bundles["paged"][1]
    dec = InferenceEngine(tn, role="decode", name="hd", device="cpu",
                          **ENG, **ARMS["paged"])
    pre = InferenceEngine(tn, role="prefill", name="hp", device="cpu",
                          **ENG, **ARMS["paged"])
    pre.migrate_to(dec.adopt)
    warm = (pre.warmup(), dec.warmup())
    with dec, pre:
        outs = _serve(pre, prompts)
        sp, sd = pre.stats(), dec.stats()
    for o, w in zip(outs, want):
        onp.testing.assert_array_equal(o, w)
    assert sp["migration"]["migrations_out"] == 2
    assert sd["migration"]["migrations_in"] == 2
    assert sp["migration"]["migrated_pages"] == \
        sd["migration"]["migrated_pages"] > 0
    assert sp["engine"]["migrate_target"] is True
    assert (sp["compile_cache"]["compiles"],
            sd["compile_cache"]["compiles"]) == warm


def _held_pair(tn, tag, gate, entered):
    """A decode engine and a prefill engine whose target holds its first
    handoff until ``gate`` is set (``entered`` says it is held)."""
    dec = InferenceEngine(tn, role="decode", name=f"{tag}d", device="cpu",
                          **ENG, **ARMS["paged"])
    pre = InferenceEngine(tn, role="prefill", name=f"{tag}p",
                          device="cpu", **ENG, **ARMS["paged"])

    def target(bundle, future):
        if not entered.is_set():
            entered.set()
            assert gate.wait(60)
        dec.adopt(bundle, future)
    pre.migrate_to(target)
    return dec, pre


def test_a_held_handoff_does_not_stall_prefill(nets, port_bundles):
    """The handoff runs on its own worker: while the target holds the
    first request, the prefill scheduler prefills the next one, and both
    continue token-identically once the target lets go."""
    _, tn = nets
    prompts, want = _prompts(), port_bundles["paged"][1]
    gate, entered = threading.Event(), threading.Event()
    dec, pre = _held_pair(tn, "hh", gate, entered)
    with dec, pre:
        f0 = pre.submit(prompts[0], max_new_tokens=MAX_NEW, **_samp(0))
        assert entered.wait(60)
        b0 = pre.metrics.counters["prefill_batches"]
        f1 = pre.submit(prompts[1], max_new_tokens=MAX_NEW, **_samp(1))
        t0 = time.monotonic()
        while pre.metrics.counters["prefill_batches"] == b0:
            assert time.monotonic() - t0 < 60, "prefill held by a handoff"
            time.sleep(0.01)
        gate.set()
        outs = [onp.asarray(f.result(timeout=120)) for f in (f0, f1)]
        sp = pre.stats()
    for o, w in zip(outs, want):
        onp.testing.assert_array_equal(o, w)
    assert sp["migration"]["migrations_out"] == 2


def test_a_stop_during_a_handoff_leaves_the_request_to_the_peer(
        nets, port_bundles):
    """``stop(drain=False)`` while the target holds a request: the
    prefill engine does not fail a request the peer may own; the peer
    adopts and serves it token-identically."""
    _, tn = nets
    prompts, want = _prompts(), port_bundles["paged"][1]
    gate, entered = threading.Event(), threading.Event()
    dec, pre = _held_pair(tn, "hs", gate, entered)
    with dec:
        pre.start()
        fut = pre.submit(prompts[0], max_new_tokens=MAX_NEW, **_samp(0))
        assert entered.wait(60)
        threading.Timer(0.2, gate.set).start()
        pre.stop(drain=False)
        onp.testing.assert_array_equal(
            onp.asarray(fut.result(timeout=120)), want[0])
    assert dec.stats()["migration"]["migrations_in"] == 1


@pytest.mark.parametrize("site", ["serving.migrate_out",
                                  "serving.migrate_in"])
def test_migrate_faults_serve_colocated(nets, port_bundles, site):
    """A fault at either site: the request is served by the prefill
    engine, token-identically, counted as a fallback; no retry budget is
    spent."""
    _, tn = nets
    want = port_bundles["paged"][1]
    dec = InferenceEngine(tn, role="decode", name="fd", device="cpu",
                          **ENG, **ARMS["paged"])
    pre = InferenceEngine(tn, role="prefill", name="fp", device="cpu",
                          **ENG, **ARMS["paged"])
    pre.migrate_to(dec.adopt)
    plan = FaultPlan().raise_at(site, at=1)
    with plan, dec, pre:
        outs = _serve(pre, _prompts())
        sp = pre.stats()
    for o, w in zip(outs, want):
        onp.testing.assert_array_equal(o, w)
    assert plan.fired(site) == 1
    assert sp["migration"]["migrate_faults"] == 1
    assert sp["migration"]["migrations_out"] == 2
    assert sp["resilience"]["retries"] == 0


def test_roles_are_validated_typed(nets):
    """Role misuse raises typed, as the reference's does."""
    _, tn = nets
    with pytest.raises(ServingError):
        InferenceEngine(tn, role="both", device="cpu", **ENG)
    uni = InferenceEngine(tn, device="cpu", name="ru", **ENG)
    with pytest.raises(ServingError):
        uni.migrate_to(lambda b, f: None)
    pre = InferenceEngine(tn, role="prefill", device="cpu", name="rp",
                          **ENG)
    with pytest.raises(ServingError):
        pre.adopt(None)
    assert uni.stats()["engine"]["role"] == "unified"
    for e in (uni, pre):
        e.stop(drain=False)
