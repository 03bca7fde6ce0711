"""The port's containment against the JAX package's: the NaN guard, the
poisons, retries, the watchdog and the lifecycle.

The same scripted traffic goes through the reference's engine and the
port's (GPT-2 at vocab 97, 32 units, 2 layers, 4 heads, 64 positions,
the reference's weights copied across); typed errors and greedy streams
compare equal, and so do the counters that record the containment:

- the NaN guard in decode (dense, paged, int8 pages) and in forward
  mode: a NaN in row 6 of the position embedding (the reference's
  ``tests/test_guardrails.py`` poison) fails exactly the request that
  reaches position 6, typed; the next tenant of its slot and pages
  equals a fresh engine's stream, and the pool is finite;
- a ``serving.kv_scale`` poison fails its reader typed, counts one
  dequant fault and drops the prefix entry over the tainted page, so
  the family's next member recomputes clean;
- a ``serving.draft_logits`` poison (the draft program's float32
  input) goes through the real rejection path: the streams stay
  ``generate``'s and the caches finite;
- a retryable fault at ``serving.decode_step`` gives the fault-free
  streams with one retry, and compiles nothing after ``warmup()``;
- a kill at ``serving.scheduler`` (outside the recovery net) fails
  every rider with ``EngineCrashedError`` through the watchdog, event
  driven (a dead thread, no wall-time bound), and ``health()`` says so;
- ``stop(drain=...)`` and the SIGTERM drain resolve every future.
"""
import os
import signal
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.resilience import FaultPlan as JFaultPlan
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.resilience import FaultPlan as TFaultPlan
from mxnet_tpu_torch.serving import EngineStoppedError, InferenceEngine
from mxnet_tpu_torch.utils.convert import load_numpy_params

CFG = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
           max_length=64, dropout=0.0)
POISONED_POSITION = 6


def _params():
    onp.random.seed(0)
    jn = jget_gpt2("gpt2_124m", **CFG)
    jn.initialize()
    return jn, {k: p.data().asnumpy()
                for k, p in jn._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def nets():
    jn, params = _params()
    return jn, load_numpy_params(
        tget_gpt2("gpt2_124m", device="cpu", **CFG), params)


@pytest.fixture(scope="module")
def poisoned():
    """Both packages' nets with NaN in the position embedding's row 6."""
    jn, params = _params()
    key, = [k for k in params if "wpe" in k]
    w = params[key].copy()
    w[POISONED_POSITION, :] = onp.nan
    params[key] = w
    jn._collect_params_with_prefix()[key].set_data(mx.nd.array(w))
    return jn, load_numpy_params(
        tget_gpt2("gpt2_124m", device="cpu", **CFG), params)


def _prompts(lens, seed=1):
    rs = onp.random.RandomState(seed)
    return [rs.randint(0, 97, (n,)).astype("int32") for n in lens]


def _ref(jn, p, n):
    return jn.generate(mx.nd.array(p[None], dtype="int32"), n,
                       temperature=0).asnumpy()[0].tolist()


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("seq_buckets", (8, 16))
    kw.setdefault("default_max_new_tokens", 8)
    kw.setdefault("watchdog_interval", 0.02)
    return kw


def _engines(nets, **kw):
    jn, tn = nets
    return (jserving.InferenceEngine(jn, **_kw(kw)),
            InferenceEngine(tn, device="cpu", **_kw(kw)))


def _outcome(fut):
    try:
        return fut.result(timeout=60).tolist()
    except Exception as e:            # each package's classes, by name
        return type(e).__name__


def _pool_finite(eng):
    """Every leaf of the port's caches finite (int8 pages through their
    scales), the zero page all zeros."""
    for layer in eng._caches:
        for a in layer.values():
            real = a[:eng.num_pages] if eng._paged else a
            assert bool(torch.isfinite(real.float()).all())
            if eng._paged:
                assert not bool(a[eng.num_pages].any())


def _counters(eng, keys):
    return {k: eng.metrics.counters[k] for k in keys}


GUARD = ("nonfinite_outputs", "pages_scrubbed", "completed", "cancelled",
         "watchdog_trips", "kv_dequant_faults", "retries")


# ---------------------------------------------------------- the NaN guard

@pytest.mark.parametrize("kw", [
    dict(kv_layout="dense", seq_buckets=(4, 8)),
    dict(kv_layout="paged", page_size=8, seq_buckets=(4, 8)),
    dict(kv_layout="paged", page_size=8, kv_quant="int8",
         seq_buckets=(4, 8)),
], ids=["dense", "paged", "int8"])
def test_nan_guard_fails_one_request_and_scrubs(poisoned, kw):
    """Row 6 of the position embedding is NaN: a request that stays
    below position 6 is served; one that reaches it fails with
    ``NonFiniteOutputError`` (its flag rode the decode step's tokens);
    the next tenant of the freed slot and pages equals a fresh
    engine's stream; the pool is finite and the engine live.  Prompts
    pad to the 4 bucket, below the poisoned position (a padded write
    there would poison the row for every reader, in both packages)."""
    jn, tn = poisoned
    script = [(onp.array([1, 2], "int32"), 2),
              (onp.array([1, 2, 3], "int32"), 8),
              (onp.array([3, 4], "int32"), 2),
              (onp.array([5, 6, 7], "int32"), 3)]
    res = []
    for eng in _engines(poisoned, **kw):
        with eng:
            outs = [_outcome(eng.submit(p, max_new_tokens=n))
                    for p, n in script]
            live = eng.health()["live"]
        res.append((outs, live, _counters(eng, GUARD)))
    assert res[1] == res[0]
    outs, live, c = res[0]
    assert outs[1] == "NonFiniteOutputError" and live
    assert c["nonfinite_outputs"] == 1 and c["completed"] == 3
    if kw["kv_layout"] == "paged":
        assert c["pages_scrubbed"] >= 1
    fresh = InferenceEngine(tn, device="cpu", **_kw(kw))
    with fresh:
        for (p, n), o in zip(script[2:], outs[2:]):
            assert fresh.infer(p, max_new_tokens=n).tolist() == o
    teng = _engines(poisoned, **kw)[1]
    with teng:
        for p, n in script:
            _outcome(teng.submit(p, max_new_tokens=n))
    _pool_finite(teng)


def test_nan_guard_in_forward_mode():
    """A forward request whose output row is NaN fails typed; the engine
    keeps serving the rest and stays live.  The flag is an output of the
    forward program."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as tnn
    jd = jnn.Dense(4, in_units=8)
    jd.initialize()
    params = {"weight": jd.weight.data().asnumpy(),
              "bias": jd.bias.data().asnumpy()}
    td = load_numpy_params(tnn.Dense(4, in_units=8), params, device="cpu")
    clean = onp.random.RandomState(0).randn(8).astype("float32")
    bad = clean.copy()
    bad[3] = onp.nan
    res = []
    for eng in (jserving.InferenceEngine(jd, max_batch=2),
                InferenceEngine(td, max_batch=2, device="cpu")):
        with eng:
            outs = [_outcome(eng.submit(x)) for x in (clean, bad, clean)]
            live = eng.health()["live"]
        res.append((outs, live, _counters(eng, GUARD)))
    assert res[1][0][1] == res[0][0][1] == "NonFiniteOutputError"
    onp.testing.assert_allclose(res[1][0][0], res[0][0][0], rtol=1e-6,
                                atol=1e-6)
    assert res[1][1:] == res[0][1:]
    assert res[0][2]["nonfinite_outputs"] == 1 and res[0][1]


# ----------------------------------------------------------------- poisons

def test_kv_scale_poison_fails_its_reader_and_drops_the_prefix(nets):
    """``serving.kv_scale``: NaN spliced into the layer-0 K scale of the
    donor's last page (in place: the programs hold the buffer).  The
    donor fails typed at its next dequant, one dequant fault is counted,
    the family's prefix entry over the tainted page is dropped, and the
    family's second member recomputes clean."""
    rs = onp.random.RandomState(31)
    shared = rs.randint(0, 97, (12,)).astype("int32")     # 1.5 pages
    fam = [onp.concatenate([shared, rs.randint(0, 97, (3,)).astype("int32")])
           for _ in range(2)]
    res = []
    for eng, plan in zip(_engines(nets, kv_layout="paged", page_size=8,
                                  kv_quant="int8", prefix_min_tokens=4),
                         (JFaultPlan, TFaultPlan)):
        with plan().nonfinite_at("serving.kv_scale", at=1) as p:
            with eng:
                donor = _outcome(eng.submit(fam[0], max_new_tokens=4))
                mid = (eng.stats()["prefix_cache"]["prefix_inserts"],
                       len(eng._prefix))
                second = _outcome(eng.submit(fam[1], max_new_tokens=4))
            fired = p.fired("serving.kv_scale")
        res.append((donor, mid, second, fired,
                    _counters(eng, GUARD + ("prefix_hits",))))
    assert res[1] == res[0]
    donor, (inserts, entries), second, fired, c = res[0]
    assert donor == "NonFiniteOutputError" and fired == 1
    assert inserts == 1 and entries == 0
    assert second == _ref(nets[0], fam[1], 4)
    assert c["kv_dequant_faults"] == 1 and c["prefix_hits"] == 0
    _pool_finite(eng)


def test_draft_logits_poison_goes_through_the_rejection_path(nets):
    """``serving.draft_logits``: NaN added to every draft's logits (the
    draft program's float32 input, 0.0 without a plan) gives garbage
    proposals that the verify rejects: the streams stay ``generate``'s,
    no request fails, the drafter's read-only caches stay finite."""
    prompts = _prompts((4, 8), seed=51)
    want = [_ref(nets[0], p, 8) for p in prompts]
    res = []
    for eng, plan in zip(_engines(nets, spec_tokens=2, draft_layers=1,
                                  max_wait_us=0.0),
                         (JFaultPlan, TFaultPlan)):
        futs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        with plan().nonfinite_at("serving.draft_logits", every=1) as p:
            with eng:
                outs = [_outcome(f) for f in futs]
            fired = p.fired("serving.draft_logits")
        sp = eng.stats()["speculative"]
        res.append((outs, fired, sp["spec_cycles"],
                     _counters(eng, GUARD)))
    assert res[1] == res[0]
    assert res[0][0] == want and res[0][1] >= 1
    assert sp["spec_tokens_accepted"] < sp["spec_tokens_proposed"]
    _pool_finite(eng)


# -------------------------------------------------------- retries and crash

def test_retryable_decode_fault_keeps_the_streams(nets):
    """A retryable raise at the second ``serving.decode_step`` is
    retried inside the riders' budgets: the same streams as without
    the fault, one retry, and no compile after ``warmup()`` (the retry
    replays the same program without counting a second bucket hit)."""
    prompts = _prompts((3, 5, 4))
    want = [_ref(nets[0], p, 4) for p in prompts]
    res = []
    jeng, teng = _engines(nets, retry_backoff=0.001)
    n_warm = teng.warmup()
    hits0 = teng.metrics.counters["bucket_hits"]
    for eng, plan in ((jeng, JFaultPlan), (teng, TFaultPlan)):
        futs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        with plan().raise_at("serving.decode_step", at=2,
                             retryable=True) as p:
            with eng:
                outs = [_outcome(f) for f in futs]
            fired = p.fired()
        res.append((outs, fired, _counters(eng, GUARD + ("decode_steps",))))
    assert res[1] == res[0]
    assert res[0][0] == want and res[0][1] == 1
    assert res[0][2]["retries"] == 1
    c = teng.metrics.counters
    assert c["compiles"] == n_warm
    # one bucket hit a logical step: the retry is not a second one
    steps = c["decode_steps"] + c["prefill_batches"] + c["prefill_chunks"]
    assert c["bucket_hits"] - hits0 == steps


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_scheduler_kill_fails_every_rider_and_a_fresh_engine_serves(nets):
    """A kill at ``serving.scheduler`` (outside the recovery net) ends
    the scheduler thread: the watchdog finds it dead, condemns the
    engine, and every queued and in-flight request fails with
    ``EngineCrashedError``; a later submit is refused typed, ``health()``
    reports the corpse, ``stop()`` returns, and a fresh engine serves."""
    prompts = _prompts((3, 5, 4))
    res = []
    for eng, plan in zip(_engines(nets), (JFaultPlan, TFaultPlan)):
        futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        with plan().kill_at("serving.scheduler", at=2):
            eng.start()
            outs = [_outcome(f) for f in futs]
            h = eng.health()
            try:
                eng.submit(prompts[0])
                later = None
            except Exception as e:
                later = type(e).__name__
            eng.stop(timeout=10)
        res.append((outs, later, h["live"], h["ready"], bool(h["crashed"]),
                    eng.stats()["engine"]["crashed"],
                    _counters(eng, GUARD)))
    assert res[1] == res[0]
    assert res[0][0] == ["EngineCrashedError"] * 3
    assert res[0][1:6] == ("EngineCrashedError", False, False, True, True)
    assert res[0][6]["watchdog_trips"] == 1
    fresh = _engines(nets)[1]
    with fresh:
        assert fresh.infer(prompts[0], max_new_tokens=4).tolist() == \
            _ref(nets[0], prompts[0], 4)


# --------------------------------------------------------------- lifecycle

def test_stop_drains_or_fails_typed_and_sigterm_drains(nets):
    """``stop(drain=True)`` finishes what was queued; an engine stopped
    before it ever ran fails its queue typed, drained or not (nothing is
    dropped); SIGTERM after ``install_signal_handlers()`` drains on a
    helper thread and restores the previous handler."""
    prompts = _prompts((3, 5, 4))
    want = [_ref(nets[0], p, 4) for p in prompts]
    res = []
    for jeng_or_teng in range(2):
        out = []
        for drain in (True, False):
            eng = _engines(nets)[jeng_or_teng]
            futs = [eng.submit(p, max_new_tokens=4) for p in prompts[:2]]
            eng.stop(drain=drain, timeout=5)
            out.append(([_outcome(f) for f in futs],
                        eng.metrics.counters["cancelled"]))
        eng = _engines(nets)[jeng_or_teng]
        futs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.start()
        eng.stop(drain=True)
        out.append(([_outcome(f) for f in futs], eng.health()["ready"]))
        res.append(out)
    assert res[1] == res[0]
    assert res[0][:2] == [(["EngineStoppedError"] * 2, 2)] * 2
    assert res[0][2] == (want, False)
    prev = signal.getsignal(signal.SIGTERM)
    eng = _engines(nets)[1].start()
    eng.install_signal_handlers()
    try:
        futs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        os.kill(os.getpid(), signal.SIGTERM)
        assert [_outcome(f) for f in futs] == want
        deadline = time.monotonic() + 30
        while eng._thread is not None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        with pytest.raises(EngineStoppedError):
            eng.submit(prompts[0])
    finally:
        eng.uninstall_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) is prev
