"""The port's observability layer (``mxnet_tpu_torch/observability/``,
``serving/metrics.py``, ``profiler.py``) against the JAX package's.

After the same operations both packages render the same Prometheus text,
JSON lines and flattened counters, the same ``ServingMetrics.stats()``
and registry samples, and the same SLO verdicts and burn rates.  The
port's ``ResilientLoop`` over ``ShardedTrainer`` records the reference's
spans (``loop.step``, ``trainer.step``, ``checkpoint.save``,
``checkpoint.commit``) and counters; with ``profiler_markers=True`` the
spans are ``torch.profiler`` ranges; a flight-recorder bundle has the
reference's sections with torch's platform facts.
"""
import json
import os

import numpy as onp
import pytest
import torch

from mxnet_tpu import observability as jobs
from mxnet_tpu.serving.metrics import ServingMetrics as JServingMetrics
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, observability as obs
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.observability import flightrecorder, slo
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.resilience import FaultPlan, ResilientLoop
from mxnet_tpu_torch.serving.metrics import ServingMetrics

# latencies in seconds across the histogram's buckets (10us .. 2 min)
_LAT = [float(x) for x in
        onp.random.RandomState(0).lognormal(-5.0, 2.0, 200)]


def _fill_registry(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("mxtpu_test_events_total", help="events",
                    engine='a"b\\c\nd')
    c.inc(3)
    c.inc()
    reg.counter("mxtpu_test_plain", help="no suffix").inc(2)
    reg.gauge("mxtpu_test_depth", help="depth", engine="x").set(7.5)
    reg.gauge("mxtpu_test_fn", fn=lambda: 4.25, replica="r1")
    h = reg.histogram("mxtpu_test_latency_seconds", help="lat",
                      phase="decode")
    for s in _LAT:
        h.observe(s)
    reg.histogram("mxtpu_test_empty_seconds")
    reg.register_collector("extra", lambda: [
        {"name": "mxtpu_test_collected", "kind": "gauge",
         "labels": {"k": "v"}, "value": 1.5, "help": ""}])
    return reg.collect()


def test_export_formats_equal_the_reference():
    snap, jsnap = _fill_registry(obs), _fill_registry(jobs)
    text = obs.to_prometheus(snap)
    assert text == jobs.to_prometheus(jsnap)
    assert obs.parse_prometheus(text) == jobs.parse_prometheus(text)
    assert obs.flatten(snap) == jobs.flatten(jsnap)
    assert obs.flatten(snap, include_zero=True) == \
        jobs.flatten(jsnap, include_zero=True)
    # JSON lines: the same sample lines; the meta line's timestamp aside
    lines, jlines = (obs.to_json_lines(snap).splitlines(),
                     jobs.to_json_lines(jsnap).splitlines())
    assert lines[1:] == jlines[1:]
    assert json.loads(lines[0]).keys() == json.loads(jlines[0]).keys()
    with pytest.raises(ValueError):
        obs.parse_prometheus(text + "torn_line{a=\"b\"\n")


def _drive_metrics(cls):
    m = cls("ep", register=False)
    for k, n in (("submitted", 9), ("completed", 7), ("timeouts", 1),
                 ("rejected_queue_full", 1), ("retries", 2),
                 ("checkpoint_commits", 3), ("bad_steps", 1),
                 ("bucket_hits", 5), ("compiles", 2),
                 ("prefix_hits", 3), ("prefix_misses", 1)):
        m.count(k, n)
    m.count_shed("queue_full", "normal")
    m.count_served("high", 2)
    m.count_migration("out", "ok")
    m.observe_migration(0.002)
    m.observe_quant_error(1e-4)
    for i, s in enumerate(_LAT[:40]):
        m.observe_request(s / 4, s / 2, s if i % 5 else None)
    return m


def test_serving_metrics_equal_the_reference():
    m, jm = _drive_metrics(ServingMetrics), _drive_metrics(JServingMetrics)
    assert m.stats() == jm.stats()
    assert m.registry_samples() == jm.registry_samples()
    assert m.latency_estimates(min_count=4) == \
        jm.latency_estimates(min_count=4)
    assert ServingMetrics._COUNTERS == JServingMetrics._COUNTERS


def test_slo_verdicts_and_burn_rates_equal_the_reference():
    def run(slo_mod, metrics_cls):
        m = metrics_cls("slo-src", register=False)
        tr = slo_mod.SLOTracker(
            slo_mod.SLO("svc", ttft_p99=0.02, deadline_hit_rate=0.9,
                        availability=0.95), m, register=False)
        out = []
        for wave in range(3):
            for s in _LAT[wave * 30:(wave + 1) * 30]:
                m.observe_request(0.0, s, 0.001)
            m.count("completed", 30)
            m.count("timeouts", wave * 2)
            m.count("rejected_queue_full", wave)
            out.append(tr.evaluate())
        return out, tr.snapshot()["objectives"]

    assert run(slo, ServingMetrics) == run(jobs.slo, JServingMetrics)
    with pytest.raises(mx.MXNetError):
        slo.SLO("bad", availability=1.0)


def _mlp_trainer():
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(8, activation="relu", in_units=6),
                nn.Dense(2, in_units=8))
        net.initialize(seed=0)
    return ShardedTrainer(net, "sgd", loss=gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer_params={"learning_rate": 0.1})


def _batches():
    for i in range(50):
        rs = onp.random.RandomState(i)
        X = rs.randn(4, 6).astype("float32")
        yield (X, (X.sum(1) > 0).astype("int32"))


def _count(samples, name):
    return sum(s["value"] for s in samples if s["name"] == name)


def test_loop_spans_counters_and_prometheus(tmp_path):
    reg = obs.default_registry()
    before = reg.collect()["samples"]
    tracer = obs.enable_tracing()
    try:
        loop = ResilientLoop(_mlp_trainer(), str(tmp_path / "run"),
                             save_every=3, seed=0)
        with FaultPlan().raise_at("trainer.step", at=2, retryable=True):
            report = loop.run(_batches, 6)
        names = [s.name for s in tracer.spans()]
        # one loop.step span per attempt (the retried one tagged error)
        assert names.count("loop.step") == 7
        assert names.count("trainer.step") == 7
        assert names.count("checkpoint.commit") == 2
        assert names.count("checkpoint.save") == 2
        failed = [s for s in tracer.spans(name="loop.step")
                  if "error" in s.attrs]
        assert [s.attrs["error"] for s in failed] == ["RetryableFault"]
        steps = [s.attrs["step"] for s in tracer.spans(name="trainer.step")]
        assert steps == [1, 2, 2, 3, 4, 5, 6]    # step 2 retried
        # nested: every trainer.step lies inside a loop.step
        outer = tracer.spans(name="loop.step")
        for s in tracer.spans(name="trainer.step"):
            assert any(o.t0 <= s.t0 and s.t1 <= o.t1 for o in outer)
        assert report["retries"] == 1
        after = reg.collect()
        text = obs.to_prometheus(after)
        parsed = obs.parse_prometheus(text)
        assert ("mxtpu_trainer_steps_total", ()) in parsed
        assert ("mxtpu_checkpoint_commits_total", ()) in parsed
        # the retried attempt raised at the fault site, before the count
        for name, n in (("mxtpu_trainer_steps_total", 6),
                        ("mxtpu_checkpoint_commits_total", 2)):
            assert _count(after["samples"], name) - \
                _count(before, name) == n
        assert ("mxtpu_serving_checkpoint_commits_total",
                (("engine", "resilience"),)) in parsed
        assert _count(after["samples"], "mxtpu_trace_ring_capacity") == 4096
    finally:
        obs.disable_tracing()
    assert obs.active_tracer() is None


def test_span_bridge_ranges_in_a_cpu_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tr = _mlp_trainer()
    x, y = next(_batches())
    tr.step(x, y)
    tracer = obs.enable_tracing(profiler_markers=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracer.span("loop.step", step=1):
                tr.step(x, y)
    finally:
        obs.disable_tracing()
    keys = {e.key for e in prof.key_averages()}
    assert {"span:loop.step", "span:trainer.step"} <= keys
    # the ranges hold the step's ops (the update's foreach kernels run
    # inside them on the CPU as on the card)
    events = prof.events()
    step = next(e for e in events if e.name == "span:trainer.step")
    inner = [e for e in events if e.time_range.start >= step.time_range.start
             and e.time_range.end <= step.time_range.end
             and e.name.startswith("aten::")]
    assert inner
    # without markers: no range
    tracer = obs.enable_tracing()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.step(x, y)
    finally:
        obs.disable_tracing()
    assert "span:trainer.step" not in {e.key for e in prof.key_averages()}


def test_flight_recorder_bundle_has_the_reference_sections(tmp_path):
    fr = obs.enable_flight_recorder(bundle_dir=str(tmp_path / "fr"),
                                    min_interval=3600.0)
    tracer = obs.enable_tracing()
    try:
        fr.record("loop.rewind", step=3, trace_id=1)
        tracer.event("loop.rewind", trace_id=1)
        with FaultPlan(seed=4).kill_at("trainer.step", at=99):
            path = fr.dump("manual.dump", note="test")
        assert fr.trigger("slo.breach") is not None
        assert fr.trigger("slo.breach") is None       # rate-limited
    finally:
        obs.disable_tracing()
        obs.disable_flight_recorder()
    bundle = json.load(open(path))
    assert bundle["kind"] == flightrecorder.BUNDLE_KIND
    v = bundle["versions"]
    assert v["torch"] == torch.__version__ and "jax" not in v
    assert v["device_count"] == (torch.cuda.device_count()
                                 if torch.cuda.is_available() else 0)
    assert v["cuda"] == torch.version.cuda
    assert bundle["fault_plan"]["seed"] == 4
    assert "1" in bundle["traces"]["timelines"]
    assert [e["name"] for e in bundle["events"]][:2] == \
        ["loop.rewind", "manual.dump"]
    assert bundle["engines"] == {} and bundle["lockwitness"] is None
    jfr = jobs.FlightRecorder(bundle_dir=str(tmp_path / "jfr"))
    jbundle = json.load(open(jfr.dump()))
    assert bundle.keys() == jbundle.keys()
    assert bundle["recorder"].keys() == jbundle["recorder"].keys()


def test_background_exporter_atomic_and_drained(tmp_path):
    reg = obs.MetricsRegistry()
    c = reg.counter("mxtpu_test_ticks_total")
    path = str(tmp_path / "out" / "metrics.prom")
    with obs.BackgroundExporter(path=path, interval=0.01,
                                registry=reg) as exp:
        c.inc(5)
    assert exp.exports >= 1 and exp.errors == 0 and not exp.is_alive()
    assert obs.parse_prometheus(open(path).read()) == {
        ("mxtpu_test_ticks_total", ()): 5.0}
    assert not [f for f in os.listdir(tmp_path / "out")
                if f.startswith(".obs-export-")]
    with pytest.raises(ValueError):
        obs.BackgroundExporter()
