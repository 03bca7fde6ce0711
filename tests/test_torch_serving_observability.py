"""The port engine's observability against the JAX package's: metrics,
registry series, spans, the flight recorder, ``stats()`` and
``debug_parity``.

The same traffic goes through the reference's engine and the port's
(GPT-2 at vocab 97, 32 units, 2 layers, 4 heads, 64 positions, the
reference's weights copied across):

- the Prometheus series of each package's registry under the engine's
  ``engine=`` label — names and labels — are equal, the reference's
  gauges, counters, histograms and compile collector alike;
- each request's span timeline names the same spans and events
  (``serving.submit``, ``serving.queue``, the batched
  ``serving.prefill``/``serving.decode_step``,
  ``serving.prefix_lookup``, ``serving.prefill_phase``,
  ``serving.decode_phase``, ``serving.request``, ``serving.complete``,
  ``serving.error`` for a failed one);
- ``stats()`` holds every key of the reference's, section by section;
  the port's additions are named;
- a flight bundle's live-engine section lists a running engine's
  ``stats()``, and a stopped one's name is released;
- ``debug_parity``: the float32 gather twin's max-abs logit delta,
  bounded 1e-4 (float32 pages) and 0.05 (int8) as the reference's
  ``tests/test_paged_attn.py`` bounds it, on the kernel arm (its plain
  version on the CPU) and the gather arm; ``compiles == warmup()``,
  whose count equals the reference's.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.serving import InferenceEngine
from mxnet_tpu_torch.utils.convert import load_numpy_params

CFG = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
           max_length=64, dropout=0.0)

# what the port's stats() adds to the reference's: its earlier flat
# counters and rates, the engine's device, and the raw TTFT and request
# latency percentiles
PORT_EXTRAS = {"": {"counters", "rates"}, "engine": {"device"},
               "latency": {"ttft", "request"}}


@pytest.fixture(scope="module")
def nets():
    onp.random.seed(0)
    jn = jget_gpt2("gpt2_124m", **CFG)
    jn.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jn._collect_params_with_prefix().items()}
    tn = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                           params)
    return jn, tn


def _prompts(lens, seed=1):
    rs = onp.random.RandomState(seed)
    return [rs.randint(0, 97, (n,)).astype("int32") for n in lens]


def _ref(jn, p, n):
    return jn.generate(mx.nd.array(p[None], dtype="int32"), n,
                       temperature=0).asnumpy()[0]


def _kw(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("seq_buckets", (8, 16))
    kw.setdefault("default_max_new_tokens", 8)
    return kw


def _family():
    rs = onp.random.RandomState(7)
    shared = rs.randint(0, 97, (10,)).astype("int32")
    return [onp.concatenate([shared, rs.randint(0, 97, (n,)).astype("int32")])
            for n in (2, 3, 4)]


def _series(registry, to_prometheus, parse, name):
    """{(series name, labels)} of one engine in a registry's text."""
    text = to_prometheus(registry.collect())
    return {key for key in parse(text)
            if dict(key[1]).get("engine") == name}


def _timelines(tracer, futs):
    return [sorted(s["name"] for s in tracer.timeline(f.trace_id))
            for f in futs]


def _keys(stats):
    return {sec: set(v) for sec, v in stats.items() if isinstance(v, dict)}


def test_series_spans_and_stats_keys_equal_the_reference(nets):
    import mxnet_tpu.observability as jobs
    import mxnet_tpu_torch.observability as tobs
    jn, tn = nets
    name = "obs_parity"
    fam = _family()
    res = {}
    for pkg, obs, make in (
            ("ref", jobs, lambda: jserving.InferenceEngine(
                jn, name=name, **_kw(kv_layout="paged", page_size=8))),
            ("port", tobs, lambda: InferenceEngine(
                tn, name=name, device="cpu",
                **_kw(kv_layout="paged", page_size=8)))):
        tracer = obs.enable_tracing(capacity=4096)
        try:
            eng = make()
            assert eng.name == name
            with eng:
                futs = [eng.submit(p, max_new_tokens=4) for p in fam[:1]]
                outs = [f.result(timeout=60) for f in futs]
                f2 = [eng.submit(p, max_new_tokens=4) for p in fam[1:]]
                outs += [f.result(timeout=60) for f in f2]
                series = _series(obs.default_registry(), obs.to_prometheus,
                                 obs.parse_prometheus, name)
                stats = eng.stats()
            res[pkg] = (outs, series, _timelines(tracer, futs + f2), stats)
        finally:
            obs.disable_tracing()
    (r_outs, r_series, r_tl, r_stats), (outs, series, tl, stats) = \
        res["ref"], res["port"]
    for o, r in zip(outs, r_outs):
        onp.testing.assert_array_equal(o, r)
    assert series == r_series
    names = {n for n, _l in series}
    assert {"mxtpu_serving_kv_bytes_per_token", "mxtpu_serving_compiles",
            "mxtpu_serving_latency_seconds_bucket",
            "mxtpu_serving_prefix_hits_total",
            "mxtpu_serving_served_total"} <= names
    assert tl == r_tl
    assert {"serving.submit", "serving.queue", "serving.prefix_lookup",
            "serving.prefill_phase", "serving.decode_phase",
            "serving.request", "serving.complete"} <= set(tl[1])
    # stats(): the reference's keys in every section, and the port's
    # named additions
    got, want = _keys(stats), _keys(r_stats)
    assert set(stats) - set(r_stats) == PORT_EXTRAS[""]
    for sec, keys in want.items():
        assert keys <= got[sec], sec
        assert got[sec] - keys == PORT_EXTRAS.get(sec, set()), sec
    for sec in ("requests", "batches", "tokens", "prefix_cache",
                "resilience", "compile_cache"):
        assert stats[sec] == r_stats[sec], sec


def test_flight_bundle_lists_the_live_engine(nets, tmp_path):
    """A bundle's ``engines`` section holds each live engine's
    ``stats()`` under its claimed name (uniquified against live
    engines); a stopped engine releases its name."""
    import mxnet_tpu.observability as jobs
    import mxnet_tpu_torch.observability as tobs
    jn, tn = nets
    sections = {}
    for pkg, obs, make in (
            ("ref", jobs, lambda n: jserving.InferenceEngine(
                jn, name=n, **_kw())),
            ("port", tobs, lambda n: InferenceEngine(
                tn, name=n, device="cpu", **_kw()))):
        fr = obs.enable_flight_recorder(bundle_dir=str(tmp_path / pkg))
        try:
            a, b = make("fr_engine"), make("fr_engine")
            assert (a.name, b.name) == ("fr_engine", "fr_engine-2")
            with open(fr.dump("test.dump")) as f:
                bundle = json.load(f)
            sections[pkg] = {n: set(s) for n, s in bundle["engines"].items()
                             if n.startswith("fr_engine")}
            a.stop()
            b.stop()
            with open(fr.dump("test.dump")) as f:
                after = json.load(f)["engines"]
            assert not [n for n in after if n.startswith("fr_engine")]
        finally:
            obs.disable_flight_recorder()
    assert set(sections["port"]) == set(sections["ref"]) == \
        {"fr_engine", "fr_engine-2"}
    for n, keys in sections["ref"].items():
        assert sections["port"][n] - keys == PORT_EXTRAS[""]


@pytest.mark.parametrize("arm", ["kernel", "gather"])
@pytest.mark.parametrize("quant,bound", [(None, 1e-4), ("int8", 0.05)],
                         ids=["f32", "int8"])
def test_debug_parity_histogram_bounded(nets, arm, quant, bound):
    """The float32 gather twin runs the same tokens over its own pages
    and the shared page table; each step's max-abs logit delta lands in
    ``stats()["quantized_kv"]["error"]``, bounded as the reference's
    test bounds it.  Greedy streams equal ``generate``'s (int8: the
    first two tokens, the reference's horizon); the twin's programs are
    the engine's, so ``compiles`` stays at ``warmup()``'s count; both
    pools stay finite."""
    jn, tn = nets
    prompts = _prompts((5, 11, 17, 3), seed=4)
    eng = InferenceEngine(tn, device="cpu", **_kw(
        num_slots=4, max_batch=4, kv_layout="paged", page_size=8,
        kv_quant=quant, paged_attention=arm, debug_parity=True,
        prefix_min_tokens=64))
    n_warm = eng.warmup()
    with eng:
        futs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
    s = eng.stats()
    assert s["compile_cache"]["compiles"] == n_warm
    err = s["quantized_kv"]["error"]
    assert err["count"] >= len(prompts) and err["max"] <= bound
    assert s["quantized_kv"]["debug_parity"] is True
    horizon = 8 if quant is None else 2
    for p, o in zip(prompts, outs):
        r = _ref(jn, p, 8)
        onp.testing.assert_array_equal(o[:len(p) + horizon],
                                       r[:len(p) + horizon])
    for caches in (eng._caches, eng._parity_caches):
        for layer in caches:
            for a in layer.values():
                assert bool(torch.isfinite(a[:eng.num_pages].float()).all())


def test_debug_parity_warmup_counts_equal_the_reference(nets):
    """The twins compile beside their primaries in ``warmup()``: the
    count equals the reference's, and traffic then compiles nothing."""
    jn, tn = nets
    kw = _kw(num_slots=2, max_batch=1, seq_buckets=(16,),
             kv_layout="paged", page_size=8, kv_quant="int8",
             debug_parity=True, prefix_min_tokens=4)
    ref = jserving.InferenceEngine(jn, **kw).warmup()
    eng = InferenceEngine(tn, device="cpu", **kw)
    assert eng.warmup() == ref
    fam = _family()
    with eng:
        for p in fam:
            onp.testing.assert_array_equal(
                eng.infer(p, max_new_tokens=3)[:len(p) + 2],
                _ref(jn, p, 3)[:len(p) + 2])
    s = eng.stats()
    assert s["compile_cache"]["compiles"] == ref
    assert s["prefix_cache"]["prefix_hits"] >= 1   # the twin's tail copy
    assert s["quantized_kv"]["error"]["max"] <= 0.05
