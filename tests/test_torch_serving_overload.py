"""The port's admission and overload control against the JAX package's.

The same scripted traffic goes through the reference's and the port's
queues, controllers and engines (GPT-2 at vocab 97, 32 units, 2 layers,
4 heads, 64 positions, the reference's weights copied across):

- the priority queue: class order, eviction of the youngest queued
  request of the lowest class strictly below an arrival (never a
  preempted continuation), ``requeue`` at the front of its class,
  ``depth_at_or_above``/``waiting_at_or_above``/``drain``;
- the AIMD controller's factor sequence and every query on it, the
  retry budget's and the circuit breaker's transitions under an
  injected clock;
- the engines: priority shed lowest first, deadline-infeasible on
  arrival (from a seeded latency history, never wall time), the
  brownout floor's shed and token caps and its recovery, paused prefix
  inserts, preemption that parks and resumes token for token (and none
  when disabled), the page victim's class floor, cancel while queued,
  mid-decode and in forward mode, and one counter and one trace event
  per rejection path.

Engines that must interleave arrivals with decoding are driven cycle by
cycle on the test's thread (no scheduler thread, ``max_wait_us=0``), so
both packages see the same schedule and their counters compare equal.
Greedy streams are held to the reference's ``generate``.
"""
import time

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.serving.engine import Request as JRequest
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.serving import (DeadlineInfeasibleError,
                                     DynamicBatcher, InferenceEngine,
                                     OverloadController,
                                     RequestTimeoutError)
from mxnet_tpu_torch.serving import overload as toverload
from mxnet_tpu_torch.serving.engine import Request as TRequest
from mxnet_tpu_torch.utils.convert import load_numpy_params

from torch_ref_nets import preserved, seeded

CFG = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
           max_length=64, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _random_states_as_found():
    """The module leaves numpy's, torch's and both ``mx.random`` states
    as it found them (its reference engines draw keys)."""
    with preserved():
        yield


@pytest.fixture(scope="module")
def nets():
    with seeded(0):
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


def _engines(nets, **kw):
    """(reference engine, port engine) of one configuration."""
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("seq_buckets", (8, 16))
    kw.setdefault("default_max_new_tokens", 8)
    kw.setdefault("prefix_pool_rows", 4)
    kw.setdefault("prefix_min_tokens", 2)
    jn, tn = nets
    return (jserving.InferenceEngine(jn, **kw),
            InferenceEngine(tn, device="cpu", **kw))


def _cycle(eng):
    """One scheduler cycle of either engine, on this thread."""
    with eng._step_lock:
        if isinstance(eng, InferenceEngine):
            eng._cycle()
        else:
            eng._decode_cycle()


def _drive(eng, until, limit=400):
    for _ in range(limit):
        if until():
            return
        _cycle(eng)
    raise AssertionError("the engine's cycles did not get there")


def _raised(fn):
    """The class name of what ``fn()`` raised (each package raises its
    own classes), or None."""
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None


def _outcome(fut):
    try:
        return fut.result(timeout=30).tolist()
    except Exception as e:            # typed errors compare by class name
        return type(e).__name__


COUNTERS = ("submitted", "admitted", "completed", "rejected_queue_full",
            "rejected_invalid", "rejected_infeasible", "rejected_crashed",
            "timeouts", "cancelled", "preemptions", "preempt_resumes",
            "brownouts", "prefix_hits", "prefix_inserts",
            "prefix_inserts_paused", "page_faults", "tokens_generated",
            "decode_steps", "prefill_batches", "prefill_chunks", "retries",
            "nonfinite_outputs", "pages_scrubbed", "watchdog_trips")


def _same_counters(jeng, teng, keys=COUNTERS):
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    assert {k: tc[k] for k in keys} == {k: jc[k] for k in keys}


# ------------------------------------------------------------ queue units

def _queue_script(DynamicBatcher, Request):
    """Arrivals, evictions, requeues and batches on one queue; the
    request numbers each step saw."""
    log = []
    ids = {}

    def req(pr, n=4, preempted=0, deadline=None):
        r = Request("decode", onp.ones(n, "int32"), 2, priority=pr,
                    deadline=deadline)
        r.preempted = preempted
        ids[r.id] = len(ids)
        return r

    def num(r):
        return None if r is None else ids[r.id]

    def put(q, r):
        try:
            return num(q.put(r))
        except Exception as e:        # each package's QueueFullError
            return type(e).__name__

    q = DynamicBatcher(max_depth=3)
    log += [put(q, req(2)), put(q, req(2)), put(q, req(1))]
    log.append((len(q), q.depth_at_or_above(1), q.depth_at_or_above(2)))
    log.append(put(q, req(0)))              # evicts the youngest best_effort
    log.append(put(q, req(2)))              # nothing strictly below: sheds
    log.append([num(r) for r in q.get_batch(3, 0.0, wait=False)])
    q2 = DynamicBatcher(max_depth=2)
    log.append(put(q2, req(2)))
    q2.requeue(req(2, n=5, preempted=1))     # front of its class
    log.append([num(r) for r in q2.get_batch(1, 0.0, wait=False)])
    q3 = DynamicBatcher(max_depth=3)
    q3.requeue(req(2, n=6, preempted=1))
    log += [put(q3, req(2)), put(q3, req(1))]
    log.append(put(q3, req(0)))             # skips the continuation
    log.append(sorted(num(r) for r in q3.drain()))
    q4 = DynamicBatcher(max_depth=2)
    for _ in range(2):
        q4.requeue(req(2, n=6, preempted=1))
    log.append(put(q4, req(0)))             # only continuations below
    now = time.monotonic()
    q5 = DynamicBatcher(max_depth=8)
    log += [put(q5, req(0, deadline=now - 1.0)), put(q5, req(0)),
            put(q5, req(1))]
    log.append((q5.waiting_at_or_above(0, now), q5.depth_at_or_above(0),
                q5.depth_highwater))
    fut = q5.get_batch(8, 0.0, wait=False)[1].future
    log.append(q5.remove(fut))
    q5.close()
    try:
        q5.put(req(0))
    except Exception as e:
        log.append(type(e).__name__)
    try:                                    # a closed queue takes no
        q5.requeue(req(1, preempted=1))     # continuation either
        log.append("requeued after close")
    except Exception as e:
        log.append(type(e).__name__)
    return log


def test_batcher_order_and_eviction_equal_the_reference():
    from mxnet_tpu.serving import DynamicBatcher as JDynamicBatcher
    ref = _queue_script(JDynamicBatcher, JRequest)
    got = _queue_script(DynamicBatcher, TRequest)
    assert ref[-2:] == ["EngineStoppedError"] * 2
    assert got == ref
    # the script's pivots, spelled out: the interactive arrival evicted
    # request 1 (the younger best_effort); the full queue of one class
    # shed the arrival; batches formed highest class first
    assert ref[4] == 1 and ref[5] == "QueueFullError"
    assert ref[6] == [3, 2, 0]


def _controller_script(ctl_cls):
    c = ctl_cls(capacity=8, interval=0.0, hold=0.05)
    t = 100.0
    out = []

    def snap(now):
        out.append((c.factor, c.brownout, c.effective_factor,
                    [c.shedding(p, now=now) for p in range(3)],
                    [c.cap_tokens(p, 16) for p in range(3)],
                    c.cap_tokens(2, 1), c.pause_inserts, c.brownouts))

    for dt, depth, misses in ((0.0, 8, 0), (0.01, 8, 0), (0.02, 8, 0),
                              (0.03, 6, 0), (0.04, 0, 0), (0.2, 0, 0),
                              (0.3, 0, 0), (0.4, 0, 0), (0.5, 0, 0),
                              (1.0, 0, 0), (2.0, 0, 2), (2.5, 1, 0),
                              (3.0, 2, 0), (3.2, 0, 0)):
        out.append(c.update(depth, misses, now=t + dt))
        snap(t + dt + 0.01)
    c.force(now=t + 4.0)
    snap(t + 4.01)
    out.append(c.set_fleet_cap(0.25))
    snap(t + 10.0)
    out.append(c.set_fleet_cap(1.0))
    snap(t + 10.0)
    out.append(c.snapshot())
    off = ctl_cls(capacity=8, enabled=False)
    off.update(8, 5, now=t)
    off.force()
    out.append((off.factor, off.shedding(2), off.set_fleet_cap(0.1)))
    return out


def test_overload_controller_factor_sequence_equals_the_reference():
    from mxnet_tpu.serving import OverloadController as JOverloadController
    ref = _controller_script(JOverloadController)
    assert _controller_script(OverloadController) == ref
    # 1.0 -> 0.5 (entered) -> 0.25 (floor), additive recovery to 1.0
    assert ref[0] is True and ref[1][0] == 0.5 and ref[5][0] == 0.25
    assert toverload.PRIORITIES == jserving.PRIORITIES
    assert toverload.SHED_REASONS == \
        jserving.overload.SHED_REASONS


def _budget_breaker_script(RetryBudget, CircuitBreaker):
    out = []
    b = RetryBudget(rate=10.0, burst=2)
    t = 50.0
    for dt in (0.0, 0.0, 0.0, 0.1, 0.1, 100.0, 100.0, 100.0, 99.0):
        out.append(b.try_acquire(now=t + dt))
    b.refund()
    out.append((b.try_acquire(now=t + 100.0), b.denied))
    br = CircuitBreaker(threshold=2, cooldown=0.5)
    t = 10.0
    script = (("allow", 0.0), ("fail", 0.0), ("allow", 0.0), ("fail", 0.0),
              ("allow", 0.1), ("allow", 0.6), ("fail", 0.6),
              ("allow", 0.7), ("ok", None), ("allow", 0.7),
              ("fail", 1.0), ("fail", 1.0), ("allow", 1.6), ("allow", 1.6),
              ("allow", 1.7), ("allow", 2.2), ("release", None),
              ("allow", 2.2), ("ok", None), ("allow", 2.2))
    for op, dt in script:
        if op == "allow":
            out.append(br.allow(now=t + dt))
        elif op == "fail":
            br.record_failure(now=t + dt)
        elif op == "release":
            br.release_probe()
        else:
            br.record_success()
        out.append(br.opens)
    return out


def test_retry_budget_and_circuit_breaker_transitions_equal_the_reference():
    ref = _budget_breaker_script(jserving.RetryBudget,
                                 jserving.CircuitBreaker)
    assert _budget_breaker_script(toverload.RetryBudget,
                                  toverload.CircuitBreaker) == ref
    assert ref[:9] == [True, True, False, True, False, True, True, False,
                       False]


# -------------------------------------------------------- engine admission

def _shed_script(eng):
    p = _prompts((4,), seed=5)[0]
    be = [eng.submit(p, priority="best_effort") for _ in range(3)]
    ia = eng.submit(p, priority="interactive")
    out = [_outcome(be[-1]), ia.done(), be[0].done(), be[1].done(),
           _raised(lambda: eng.submit(p, priority="best_effort")),
           _raised(lambda: eng.submit(p, priority="no_such_class"))]
    eng.stop(drain=False)
    out.append([_outcome(f) for f in be[:2] + [ia]])
    return out, eng.stats()["overload"]["sheds"]


def test_priority_shed_lowest_first(nets):
    """At depth an interactive arrival evicts the youngest queued
    best_effort request, whose future fails typed; a best_effort arrival
    with nothing below it sheds itself.  No interactive request is shed
    while lower work is queued."""
    jeng, teng = _engines(nets, queue_depth=3)
    ref, got = _shed_script(jeng), _shed_script(teng)
    assert got == ref
    assert ref[0] == ["QueueFullError", False, False, False,
                      "QueueFullError", "InvalidRequestError",
                      ["EngineStoppedError"] * 3]
    assert ref[1] == {"priority_shed": {"best_effort": 1},
                      "queue_full": {"best_effort": 1}}
    _same_counters(jeng, teng)


def _seed_history(eng, n=10, prefill_s=0.01, decode_s=0.08, tokens=8):
    """A latency history for the deadline gate without running traffic
    (the reference's ``tests/test_overload.py`` helper)."""
    for _ in range(n):
        eng.metrics.observe_request(0.0, prefill_s, decode_s)
    eng.metrics.count("tokens_generated", n * tokens)
    eng.metrics.count("decode_tokens_observed", n * tokens)


def _deadline_script(eng):
    _seed_history(eng)
    p = _prompts((4,), seed=6)[0]
    for _ in range(6):
        eng.submit(p, priority="batch")
    refused = _raised(lambda: eng.submit(p, timeout=0.01, priority="batch"))
    ok_b = eng.submit(p, timeout=60.0, priority="batch")
    # an interactive request waits only behind its own class
    ok_i = eng.submit(p, timeout=0.9, priority="interactive")
    out = [refused, ok_b.done(), ok_i.done(),
           eng.stats()["overload"]["sheds"],
           eng.stats()["overload"]["rejected_infeasible"]]
    eng.stop(drain=False)
    return out


def test_deadline_infeasible_on_arrival(nets):
    jeng, teng = _engines(nets, queue_depth=16)
    ref, got = _deadline_script(jeng), _deadline_script(teng)
    assert got == ref
    assert ref == ["DeadlineInfeasibleError", False, False,
                   {"deadline_infeasible": {"batch": 1}}, 1]
    assert issubclass(DeadlineInfeasibleError, RequestTimeoutError)
    _same_counters(jeng, teng)


def test_brownout_floor_caps_and_recovery(nets):
    """At the floor best_effort arrivals shed typed while the rest are
    admitted with non-interactive budgets capped at the factor (0.25 of
    8 = 2 tokens); the started engine's controller recovers to 1.0 by
    itself once the queue is empty."""
    jn, _tn = nets
    p = _prompts((4,), seed=7)[0]
    res = {}
    for eng in _engines(nets, queue_depth=8, max_wait_us=0.0,
                        overload_controller=None):
        eng._overload = type(eng._overload)(8, hold=5.0)
        eng.force_brownout("test")
        shed = _raised(lambda: eng.submit(p, priority="best_effort"))
        s = eng.stats()["overload"]
        fut_b = eng.submit(p, max_new_tokens=8, priority="batch")
        fut_i = eng.submit(p, max_new_tokens=8, priority="interactive")
        _drive(eng, lambda: fut_b.done() and fut_i.done())
        res[type(eng).__module__] = (
            shed, s["sheds"], s["controller"]["brownout"], s["brownouts"],
            _outcome(fut_b), _outcome(fut_i))
        eng.stop()
    ref, got = res.values()
    assert got == ref
    assert ref[:4] == ("QueueFullError", {"brownout": {"best_effort": 1}},
                       True, 1)
    assert ref[4] == _ref(jn, p, 2).tolist()
    assert ref[5] == _ref(jn, p, 8).tolist()
    # recovery: the scheduler ticks the controller even while idle
    teng = InferenceEngine(nets[1], device="cpu", num_slots=2, max_batch=2,
                           seq_buckets=(8, 16))
    with teng:
        teng.force_brownout("test")
        deadline = time.monotonic() + 30
        while teng._overload.factor < 1.0:
            assert time.monotonic() < deadline, teng.stats()["overload"]
            time.sleep(0.02)
        assert not teng.stats()["overload"]["controller"]["brownout"]


def test_brownout_pauses_prefix_inserts(nets):
    """During brownout a new prompt's insert is paused (counted); after
    recovery the next one inserts."""
    p = _prompts((6,), seed=8)[0]
    counts = []
    for eng in _engines(nets, max_wait_us=0.0):
        eng._overload.force()
        f1 = eng.submit(p, max_new_tokens=2)
        _drive(eng, f1.done)
        c1 = (eng.metrics.counters["prefix_inserts_paused"],
              eng.metrics.counters["prefix_inserts"])
        eng._overload.factor = 1.0
        f2 = eng.submit(_prompts((7,), seed=9)[0], max_new_tokens=2)
        _drive(eng, f2.done)
        counts.append((c1, eng.metrics.counters["prefix_inserts"],
                       _outcome(f1), _outcome(f2)))
        eng.stop()
    assert counts[1] == counts[0]
    assert counts[0][:2] == ((1, 0), 1)


# ------------------------------------------------------------- preemption

def _preempt_script(eng, be_prompts, ia_prompt):
    be = [eng.submit(p, max_new_tokens=16, priority="best_effort")
          for p in be_prompts]
    _drive(eng, lambda: eng.metrics.counters["decode_steps"] >= 2)
    ia = eng.submit(ia_prompt, max_new_tokens=2, priority="interactive")
    _drive(eng, lambda: all(f.done() for f in be + [ia]))
    eng.stop()
    return [_outcome(f) for f in be + [ia]]


@pytest.mark.parametrize("preemption", [True, False])
def test_preemption_parks_and_resumes_token_identical(nets, preemption):
    """An interactive arrival with every slot busy preempts a
    best_effort decode: its progress parks in the prefix pool, it
    requeues, resumes by prefix hit, and every stream equals
    ``generate``'s, the preempted one included; with ``preemption``
    off nothing is preempted.  Counters equal the reference's, and
    nothing compiled after ``warmup()``."""
    jn, _tn = nets
    be_prompts = _prompts((6, 7), seed=9)
    ia_prompt = _prompts((5,), seed=10)[0]
    want = [_ref(jn, p, 16).tolist() for p in be_prompts] + \
        [_ref(jn, ia_prompt, 2).tolist()]
    jeng, teng = _engines(nets, max_wait_us=0.0, preemption=preemption)
    n_warm = teng.warmup()
    ref = _preempt_script(jeng, be_prompts, ia_prompt)
    got = _preempt_script(teng, be_prompts, ia_prompt)
    assert ref == want and got == want
    _same_counters(jeng, teng)
    c = teng.metrics.counters
    if preemption:
        assert c["preemptions"] >= 1 and c["preempt_resumes"] >= 1
        assert c["prefix_hits"] >= 1
    else:
        assert c["preemptions"] == 0
    assert c["compiles"] == n_warm


def test_page_victim_class_floor(nets):
    """ROADMAP queue C's page victim: when a best_effort slot's page
    growth runs the pool dry, a younger interactive slot is not a
    victim (a class above the grower's); the grower parks itself, and
    resumes token-identically once pages free.  The reference's
    schedule, counters and streams."""
    jn, _tn = nets
    p_be, p_ia = _prompts((14, 14), seed=11)
    want = [_ref(jn, p_be, 40).tolist(), _ref(jn, p_ia, 20).tolist()]
    parked = {}
    outs = {}
    for eng in _engines(nets, kv_layout="paged", page_size=8, num_pages=8,
                        max_wait_us=0.0, prefix_pool_rows=0,
                        prefix_min_tokens=64):
        name = type(eng).__module__
        parked[name] = []
        preempt = eng._preempt

        def record(slot, st, preempt=preempt, log=parked[name]):
            log.append(st.request.priority_name)
            preempt(slot, st)
        eng._preempt = record
        be = eng.submit(p_be, max_new_tokens=40, priority="best_effort")
        _drive(eng, lambda: eng.metrics.counters["decode_steps"] >= 1)
        ia = eng.submit(p_ia, max_new_tokens=20, priority="interactive")
        _drive(eng, lambda: be.done() and ia.done())
        outs[name] = [_outcome(be), _outcome(ia)]
        eng.stop()
    jeng_name, teng_name = list(outs)
    assert outs[teng_name] == outs[jeng_name] == want
    assert parked[teng_name] == parked[jeng_name]
    assert parked[teng_name] and set(parked[teng_name]) == {"best_effort"}


# ----------------------------------------------------------- cancellation

def test_cancel_queued_mid_decode_and_forward(nets):
    """A queued request is dequeued and fails typed; a mid-decode
    cancel frees the slot and its pages at the next cycle boundary;
    forward mode cancels queued requests only."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as tnn
    p = _prompts((6,), seed=13)[0]
    res = []
    for eng in _engines(nets, num_slots=1, max_batch=1, max_wait_us=0.0,
                        kv_layout="paged", page_size=8, prefix_pool_rows=0,
                        prefix_min_tokens=64):
        queued = eng.submit(p)
        out = [eng.cancel(queued), _outcome(queued), len(eng._batcher),
               eng.cancel(queued)]
        fut = eng.submit(p, max_new_tokens=24)
        _drive(eng, lambda: eng.metrics.counters["decode_steps"] >= 1)
        out.append(eng.cancel(fut))
        _cycle(eng)
        out += [_outcome(fut), eng._alloc.active_count,
                eng._pool.free_count == eng.num_pages,
                eng.metrics.counters["cancelled"]]
        eng.stop()
        res.append(out)
    assert res[1] == res[0]
    assert res[0] == [True, "RequestCancelledError", 0, False, True,
                      "RequestCancelledError", 0, True, 2]
    jd = jnn.Dense(4, in_units=8)
    jd.initialize()
    td = tnn.Dense(4, in_units=8)
    td.initialize(device="cpu", seed=0)
    x = onp.zeros(8, "float32")
    fwd = []
    for eng in (jserving.InferenceEngine(jd, max_batch=2),
                InferenceEngine(td, max_batch=2, device="cpu")):
        fut = eng.submit(x)
        out = [eng.cancel(fut), _outcome(fut)]
        with eng:
            f2 = eng.submit(x)
            f2.result(timeout=60)
            out += [eng.cancel(f2), len(eng._cancels)]
        fwd.append(out)
    assert fwd[1] == fwd[0] == [True, "RequestCancelledError", False, 0]


# ------------------------------------------------------- submit-path audit

def _audit_script(make, tracer, p):
    """Every submit() rejection path stamps exactly one counter and one
    trace event: (reason, counter moved, events moved, submitted moved)
    for each."""
    rows = []

    def audit(eng, fn, exc_type, counter, event, reason):
        c0 = eng.metrics.counters[counter]
        e0 = len([s for s in tracer.spans(name=event)
                  if s.attrs.get("reason") == reason])
        sub0 = eng.metrics.counters["submitted"]
        assert _raised(fn) == exc_type
        e1 = len([s for s in tracer.spans(name=event)
                  if s.attrs.get("reason") == reason])
        rows.append((reason, eng.metrics.counters[counter] - c0, e1 - e0,
                     eng.metrics.counters["submitted"] - sub0))

    eng = make()
    eng._crashed = RuntimeError("test corpse")
    audit(eng, lambda: eng.submit(p), "EngineCrashedError",
          "rejected_crashed", "serving.reject", "crashed")
    eng._crashed = None
    audit(eng, lambda: eng.submit(onp.zeros((2, 4), "int32")),
          "InvalidRequestError", "rejected_invalid", "serving.reject",
          "invalid")
    audit(eng, lambda: eng.submit(p, priority="interactve"),
          "InvalidRequestError", "rejected_invalid", "serving.reject",
          "invalid")
    small = make(queue_depth=1)
    small.submit(p)
    audit(small, lambda: small.submit(p), "QueueFullError",
          "rejected_queue_full", "serving.shed", "queue_full")
    small.stop(drain=False)
    eng.force_brownout("test")
    audit(eng, lambda: eng.submit(p, priority="best_effort"),
          "QueueFullError", "rejected_queue_full", "serving.shed",
          "brownout")
    eng._overload.factor = 1.0
    _seed_history(eng)
    for _ in range(6):
        eng.submit(p)
    audit(eng, lambda: eng.submit(p, timeout=0.01),
          "DeadlineInfeasibleError", "rejected_infeasible", "serving.shed",
          "deadline_infeasible")
    eng.stop(drain=False)
    ev = make(queue_depth=1)
    victim = ev.submit(p, priority="best_effort")
    e0 = len([s for s in tracer.spans(name="serving.shed")
              if s.attrs.get("reason") == "priority_shed"])
    ev.submit(p, priority="interactive")
    rows.append(("priority_shed", _outcome(victim),
                 ev.metrics.counters["rejected_queue_full"],
                 len([s for s in tracer.spans(name="serving.shed")
                      if s.attrs.get("reason") == "priority_shed"]) - e0))
    ev.stop(drain=False)
    return rows


def test_every_rejection_stamps_one_counter_one_trace_event(nets):
    from mxnet_tpu.observability import trace as jtrace
    from mxnet_tpu_torch.observability import trace as ttrace
    p = _prompts((4,), seed=14)[0]
    jn, tn = nets
    rows = []
    for trace, make in (
            (jtrace, lambda **kw: _engines(nets, **kw)[0]),
            (ttrace, lambda **kw: InferenceEngine(
                tn, device="cpu", num_slots=2, max_batch=2,
                seq_buckets=(8, 16), default_max_new_tokens=8,
                prefix_pool_rows=4, prefix_min_tokens=2, **kw))):
        tracer = trace.enable(capacity=512)
        try:
            rows.append(_audit_script(make, tracer, p))
        finally:
            trace.disable()
    assert rows[1] == rows[0]
    assert rows[0][:6] == [
        ("crashed", 1, 1, 0), ("invalid", 1, 1, 0), ("invalid", 1, 1, 0),
        ("queue_full", 1, 1, 1), ("brownout", 1, 1, 1),
        ("deadline_infeasible", 1, 1, 1)]
    assert rows[0][6] == ("priority_shed", "QueueFullError", 1, 1)
