"""The port's lock witness (``mxnet_tpu_torch/analysis/lockwitness.py``)
against the JAX package's.

Disabled, the constructors return plain ``threading`` primitives.
Enabled, both witnesses report the same findings on the same
interleavings: a lock-order inversion (a cycle), two locks of one site
nested (``same_site``), a blocking call under a held lock, and what the
shipped allowlist (the reference's file) suppresses.  The port's locks
carry the reference's site names.
"""
import json
import re
import threading
from pathlib import Path

import pytest

from mxnet_tpu.analysis import lockwitness as jlw
from mxnet_tpu_torch.analysis import lockwitness as lw

_PORT = Path(lw.__file__).resolve().parents[1]
_REF = Path(jlw.__file__).resolve().parents[1]


@pytest.fixture
def both():
    """Enable a witness in each package; disable both after."""
    ws = (lw.enable(), jlw.enable())
    try:
        yield ((lw, ws[0]), (jlw, ws[1]))
    finally:
        lw.disable()
        jlw.disable()


def test_disabled_constructors_return_plain_primitives():
    assert lw.active_witness() is None
    assert type(lw.named_lock("test.plain")) is type(threading.Lock())
    assert type(lw.named_rlock("test.plain_r")) is type(threading.RLock())
    assert type(lw.named_condition("test.plain_c")) is threading.Condition
    lw.note_blocking("test.nothing")        # one global load, a no-op
    assert {"test.plain", "test.plain_r", "test.plain_c"} <= \
        set(lw.known_lock_sites())


def _scenarios(mod):
    """The same interleavings for either package's module."""
    a, b = mod.named_lock("test.a"), mod.named_lock("test.b")
    with a:
        with b:
            pass
    done = threading.Event()

    def other():
        with b:
            with a:                          # B -> A closes the cycle
                pass
        done.set()
    t = threading.Thread(target=other)
    t.start()
    t.join(10)
    assert done.is_set()
    r1, r2 = mod.named_rlock("test.replica"), mod.named_rlock("test.replica")
    with r1:
        with r1:                             # re-entry: no edge
            with r2:                         # same site, two locks
                pass
    held, cond = mod.named_lock("test.held"), mod.named_condition("test.cv")
    with held:
        mod.note_blocking("test.dispatch")
        with cond:
            cond.wait(0.001)                 # waits holding test.held
    with cond:
        cond.wait(0.001)                     # only its own lock: fine


def _findings(report):
    return sorted((f["kind"], tuple(sorted(f["sites"])))
                  for f in report["findings"])


def test_findings_equal_the_reference(both):
    reports = []
    for mod, w in both:
        _scenarios(mod)
        assert len(w.cycles()) == 1
        reports.append(w.report())
    got, want = reports
    assert _findings(got) == _findings(want) == [
        ("blocking", ("test.cv.wait", "test.held")),
        ("blocking", ("test.dispatch", "test.held")),
        ("cycle", ("test.a", "test.b")),
        ("same_site", ("test.replica",)),
    ]
    for k in ("nodes", "edges", "edge_list", "acquisitions", "per_site",
              "cycles"):
        assert got[k] == want[k], k


def test_strict_mode_raises_and_releases():
    w = lw.enable(raise_on_cycle=True)
    try:
        a, b = lw.named_lock("test.sa"), lw.named_lock("test.sb")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(lw.LockOrderError):
                a.acquire()
            assert not a.locked()            # the raw lock was given back
        assert w.report()["cycles"] == 1
    finally:
        lw.disable()


def test_allowlist_is_the_reference_file_and_suppresses():
    port = json.loads((_PORT / "analysis" / "lockwitness_allowlist.json")
                      .read_text())
    assert port == json.loads(Path(jlw.DEFAULT_ALLOWLIST_PATH).read_text())
    w = lw.enable()
    try:
        step = lw.named_lock("serving.engine.step")
        with step:
            lw.note_blocking("serving.dispatch")
        assert w.findings == [] and len(w.allowed) == 1
    finally:
        lw.disable()


_SITE_RE = re.compile(
    r"named_(?:lock|rlock|condition)\(\s*\"([a-z0-9_.]+)\"", re.S)


def _sites_in(root):
    out = {}
    for path in sorted(root.rglob("*.py")):
        for m in _SITE_RE.finditer(path.read_text()):
            out.setdefault(m.group(1), set()).add(
                path.relative_to(root).as_posix())
    return out


def test_port_lock_sites_are_the_reference_names():
    port, ref = _sites_in(_PORT), _sites_in(_REF)
    assert set(port) <= set(ref), set(port) - set(ref)
    # the port's own locks under the reference's names, module by module
    for site, where in (("random.generator", "random.py"),
                        ("native.build", "utils/native.py"),
                        ("serving.engine.cond", "serving/engine.py"),
                        ("serving.engine.step", "serving/engine.py"),
                        ("serving.batcher.cond", "serving/batcher.py"),
                        ("serving.metrics", "serving/metrics.py"),
                        ("faults.plan", "resilience/faults.py"),
                        ("obs.registry", "observability/registry.py")):
        assert where in port[site] and where in ref[site], site
    # the engine's counters take the lock the reference's ServingMetrics
    # holds over them
    assert port["serving.metrics"] == {"serving/engine.py",
                                       "serving/metrics.py"}
    # every module of the port that owns a lock takes it from the witness
    plain = [p.relative_to(_PORT).as_posix() for p in _PORT.rglob("*.py")
             if re.search(r"threading\.(R?Lock|Condition)\(\)",
                          p.read_text())
             and p.name != "lockwitness.py"]
    assert plain == []


def test_the_port_engine_batcher_and_registry_under_the_witness():
    from mxnet_tpu_torch.observability import MetricsRegistry
    from mxnet_tpu_torch.serving.batcher import DynamicBatcher
    w = lw.enable()
    try:
        batcher = DynamicBatcher(4)
        assert isinstance(batcher._cond, lw._WitnessedCondition)
        reg = MetricsRegistry()
        reg.counter("mxtpu_test_total").inc()
        reg.collect()
        rep = w.report()
        assert rep["findings"] == [] and rep["cycles"] == 0
        assert {"obs.registry", "obs.metric"} <= set(rep["per_site"])
    finally:
        lw.disable()
