"""The port's resilience layer (``mxnet_tpu_torch/resilience/``) against
the JAX package's.

- Fault plans: the same declared sites (``known_sites()``), and one
  seeded plan fires on the same hits in both packages.
- Integrity: ``write_manifest``, ``TreeHasher`` and ``file_digest`` give
  the reference's digests for the same bytes; corruption is detected,
  quarantined and fallen back from.
- Checkpoints cross packages: a step directory written by either
  package's ``AtomicCheckpointer`` from the reference's resilience MLP
  (``tests/test_resilience.py:262-275``, 6 -> 16 -> 2, Adam at 0.01)
  restores into the other's trainer bit for bit.
- ``ResilientLoop``: a run killed at three distinct steps and resumed by
  fresh trainers ends bit-identical to the fault-free run (a tiny
  GPT-2, dropout 0 and 0.1); the port's loop and the reference's, from
  the same weights and batches under the same fault plan, report the
  same counters, and their losses agree within
  ``tests/test_torch_train.py``'s tolerance (relative 1e-5, parameters
  1e-4); retry, SIGTERM, and the three ``on_bad_step`` policies; the
  poison splice through the uncaptured (CPU) step.
"""
import ast
import os
import signal
import threading
import time

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.resilience import AtomicCheckpointer as JCheckpointer
from mxnet_tpu.resilience import FaultPlan as JPlan
from mxnet_tpu.resilience import ResilientLoop as JLoop
from mxnet_tpu.resilience import SimulatedPreemption as JPreemption
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.resilience import integrity as jintegrity
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.amp import LossScaler
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.resilience import (AtomicCheckpointer,
                                        CheckpointCorruptError, FaultPlan,
                                        InjectedFault, NonFiniteStepError,
                                        ResilientLoop, RetryableFault,
                                        SimulatedPreemption, Watchdog,
                                        active_plan, inject, poison)
from mxnet_tpu_torch.resilience import faults, integrity
from mxnet_tpu_torch.utils.convert import load_numpy_params

LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4

# ad-hoc sites exercising the fault machinery, in both packages
_TEST_SITES = ("test.a", "test.b", "test.s")
for _s in _TEST_SITES:
    faults.register_site(_s, "test_torch_resilience fixture site")
    jfaults.register_site(_s, "test_torch_resilience fixture site")

_W1 = onp.random.RandomState(42).randn(16, 6).astype("float32") * 0.1
_W2 = onp.random.RandomState(43).randn(2, 16).astype("float32") * 0.1


def _mlp_params():
    return {"0.weight": _W1, "0.bias": onp.zeros(16, "float32"),
            "1.weight": _W2, "1.bias": onp.zeros(2, "float32")}


def _port_mlp(**kw):
    """The reference's resilience MLP on the port, on the CPU."""
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu", in_units=6),
                nn.Dense(2, in_units=16))
        net.initialize()
    load_numpy_params(net, _mlp_params())
    return ShardedTrainer(net, "adam",
                          loss=gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer_params={"learning_rate": 0.01}, **kw)


class _RefMLP:
    """The same MLP and trainer in the reference, over a one-device
    mesh; ``step``/``state_dict``/``load_state_dict`` run inside it."""

    def __init__(self, **kw):
        self.mesh = jpar.make_mesh(dp=1, devices=jax.devices()[:1])
        net = jnn.HybridSequential()
        net.add(jnn.Dense(16, activation="relu", in_units=6),
                jnn.Dense(2, in_units=16))
        net.initialize()
        net[0].weight.set_data(jmx.nd.array(_W1))
        net[0].bias.set_data(jmx.nd.array(onp.zeros(16, "float32")))
        net[1].weight.set_data(jmx.nd.array(_W2))
        net[1].bias.set_data(jmx.nd.array(onp.zeros(2, "float32")))
        with jpar.use_mesh(self.mesh):
            self.tr = jpar.ShardedTrainer(
                net, "adam", loss=jgluon.loss.SoftmaxCrossEntropyLoss(),
                optimizer_params={"learning_rate": 0.01}, mesh=self.mesh,
                **kw)
        self._built = False

    def build(self, data, labels):
        with jpar.use_mesh(self.mesh):
            self.tr.build(data, labels)
        self._built = True

    def step(self, data, labels):
        with jpar.use_mesh(self.mesh):
            return self.tr.step(tuple(jmx.nd.array(x) for x in data),
                                tuple(jmx.nd.array(x) for x in labels))

    def state_dict(self):
        return self.tr.state_dict()

    def load_state_dict(self, d):
        with jpar.use_mesh(self.mesh):
            self.tr.load_state_dict(d)

    def params(self):
        return [p.data().asnumpy() for _n, p in self.tr._trainable]


def _mlp_batches():
    for i in range(100):
        rs = onp.random.RandomState(1000 + i)
        X = rs.randn(8, 6).astype("float32")
        yield (X, (X.sum(1) > 0).astype("int32"))


def _port_params(tr):
    return [p.detach().clone() for _n, p in tr._trainable]


def _state(tr):
    """Every tensor of a port trainer's state, cloned."""
    return {k: v.clone() for k, v in tr.state_dict().items()}


def _same_state(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ fault plans


def _module_sites(path):
    """The sites a faults module registers at import (its top-level
    ``register_site("...")`` calls)."""
    calls = (stmt.value for stmt in ast.parse(open(path).read()).body
             if isinstance(stmt, ast.Expr))
    return {c.args[0].value for c in calls if isinstance(c, ast.Call)
            and getattr(c.func, "id", None) == "register_site"}


def test_known_sites_equal_the_reference():
    ref = _module_sites(jfaults.__file__)
    assert len(ref) == 39
    assert _module_sites(faults.__file__) == ref
    # the live registries: the same, but for sites tests add themselves
    live = {s for s in faults.known_sites() if not s.startswith("test.")}
    jlive = {s for s in jfaults.known_sites()
             if not s.startswith(("test.", "fixture."))}
    assert live == jlive == ref


def _fire_pattern(plan_cls, inject_fn, exc_cls):
    plan = (plan_cls(seed=11)
            .raise_at("test.s", prob=0.3)
            .raise_at("test.a", at=3)
            .raise_at("test.b", every=2, max_fires=2))
    out = []
    with plan:
        for site in ("test.s",) * 64 + ("test.a",) * 5 + ("test.b",) * 8:
            try:
                inject_fn(site)
                out.append(0)
            except exc_cls:
                out.append(1)
    return out, list(plan.log), dict(plan.hits)


def test_plan_fires_on_the_same_hits_as_the_reference():
    got = _fire_pattern(FaultPlan, inject, InjectedFault)
    want = _fire_pattern(JPlan, jfaults.inject, jfaults.InjectedFault)
    assert got == want
    assert sum(got[0][:64]) > 0
    # the poison queries count hits and fire alike
    for cls, fn in ((FaultPlan, poison), (JPlan, jfaults.poison)):
        plan = cls(seed=3).nonfinite_at("test.a", every=3, max_fires=2)
        with plan:
            vals = [fn("test.a") for _ in range(9)]
        assert [v is not None for v in vals] == [0, 0, 1, 0, 0, 1, 0, 0, 0]


def test_plan_scoping_kills_and_unknown_sites():
    assert active_plan() is None
    inject("test.a")                       # no plan: a no-op
    plan = FaultPlan().kill_at("test.a", at=1)
    with plan:
        with pytest.raises(mx.MXNetError):
            with FaultPlan():              # plans do not nest
                pass
        try:
            inject("test.a")
        except Exception:                  # a kill is not an Exception
            pytest.fail("a kill was swallowed by except Exception")
        except SimulatedPreemption:
            pass
    assert active_plan() is None
    with pytest.raises(faults.UnknownFaultSiteError):
        FaultPlan().raise_at("serving.decode_setp", at=1)
    with pytest.raises(ValueError):
        FaultPlan().nonfinite_at("test.a", at=1, value=1.0)


# -------------------------------------------------------------- integrity


@pytest.mark.parametrize("nbytes", [0, 5000, (3 << 20) + 123])
def test_digests_and_manifests_equal_the_reference(tmp_path, nbytes):
    data = onp.random.RandomState(nbytes).bytes(nbytes)
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "state.mxtpu").write_bytes(data)
        (d / "meta.json").write_text('{"step": 1, "integrity": 1}')
    integrity.write_manifest(str(tmp_path / "port"))
    jintegrity.write_manifest(str(tmp_path / "ref"))
    assert (tmp_path / "port" / "MANIFEST.json").read_text() == \
        (tmp_path / "ref" / "MANIFEST.json").read_text()
    want = jintegrity.file_digest(str(tmp_path / "ref" / "state.mxtpu"))
    assert integrity.file_digest(str(tmp_path / "port" / "state.mxtpu")) \
        == want
    # the tee digest, fed in uneven pieces of immutable and mutable
    # buffers, is the file digest
    h, rs, i = integrity.TreeHasher(), onp.random.RandomState(1), 0
    kinds = (bytes, bytearray, lambda b: onp.frombuffer(b, onp.uint8).copy())
    while i < nbytes:
        n = int(rs.randint(1, 1 << 21))
        h.update(kinds[rs.randint(3)](data[i:i + n]))
        i += n
    assert h.hexdigest() == want
    assert integrity.verify_step_dir(str(tmp_path / "port")) == \
        ("intact", None)
    if nbytes:
        integrity.flip_bytes(str(tmp_path / "port" / "state.mxtpu"))
        jintegrity.flip_bytes(str(tmp_path / "ref" / "state.mxtpu"))
        assert (tmp_path / "port" / "state.mxtpu").read_bytes() == \
            (tmp_path / "ref" / "state.mxtpu").read_bytes()
        status, why = integrity.verify_step_dir(str(tmp_path / "port"))
        assert status == "corrupt" and "digest" in why
    a = onp.arange(64, dtype=onp.float32)
    b = a.copy()
    integrity.flip_array_bytes(a, count=3)
    jintegrity.flip_array_bytes(b, count=3)
    assert a.tobytes() == b.tobytes()


def test_latency_tracker_matches_the_reference():
    port, ref = integrity.LatencyTracker(window=8), \
        jintegrity.LatencyTracker(window=8)
    for s in onp.random.RandomState(0).exponential(0.01, 20):
        port.observe(s)
        ref.observe(s)
    assert port.snapshot() == ref.snapshot()


# ------------------------------------------------------------ checkpoints


def _tree(v, n=6):
    return {"w": torch.full((n,), float(v)),
            "b": torch.arange(n, dtype=torch.float32) * v}


@pytest.mark.chaos
def test_checkpointer_commit_gc_kill_and_fallback(tmp_path):
    ck = AtomicCheckpointer(str(tmp_path), max_to_keep=2)
    with pytest.raises(mx.MXNetError, match=r"all_steps=\[\]"):
        ck.restore()
    for s in (1, 2, 3):
        ck.save(s, _tree(s), meta={"note": "t"})
    assert ck.all_steps() == [2, 3]
    assert ck.last_save["step"] == 3 and ck.last_save["bytes"] == 48
    tree, meta = ck.restore()
    assert meta["step"] == 3 and meta["note"] == "t"
    assert torch.equal(tree["w"], _tree(3)["w"])
    # a kill at the commit leaves the latest step as it was
    with FaultPlan().kill_at("checkpoint.commit", at=1):
        with pytest.raises(SimulatedPreemption):
            ck.save(4, _tree(4))
    assert ck.latest_step() == 3
    AtomicCheckpointer(str(tmp_path))      # a fresh process sweeps .tmp-
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp-")]
    # bit rot after the commit: the step is quarantined, restore falls back
    with FaultPlan().corrupt_at("checkpoint.corrupt", at=1):
        ck.save(4, _tree(4))
    # (the GC kept step 3, the newest intact one, and took step 2)
    assert ck.all_steps() == [3, 4]
    tree, meta = ck.restore()
    assert meta["step"] == 3 and ck.quarantined() == ["corrupt-00000004"]
    assert torch.equal(tree["b"], _tree(3)["b"])
    integrity.flip_bytes(os.path.join(ck._step_dir(3), "state.mxtpu"))
    with pytest.raises(CheckpointCorruptError) as e:
        ck.restore()
    assert e.value.quarantined == [3]


@pytest.mark.chaos
def test_serialization_commit_is_atomic_and_tees(tmp_path):
    from mxnet_tpu_torch.utils.serialization import load, save
    fname = str(tmp_path / "states.mxtpu")
    h = integrity.TreeHasher()
    save(fname, {"s": onp.full(8, 7.0, "float32")}, tee=h)
    assert h.hexdigest() == integrity.file_digest(fname)
    before = open(fname, "rb").read()
    with FaultPlan().kill_at("serialization.commit", at=1):
        with pytest.raises(SimulatedPreemption):
            save(fname, {"s": onp.zeros(8, "float32")})
    assert open(fname, "rb").read() == before
    onp.testing.assert_array_equal(load(fname)["s"],
                                   onp.full(8, 7.0, "float32"))
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]


def test_checkpoints_cross_packages(tmp_path):
    """A step directory of either package restores into the other's
    trainer bit for bit, and the next step agrees."""
    batches = list(_mlp_batches())[:4]
    ref = _RefMLP()
    for x, y in batches[:3]:
        ref.step((x,), (y,))
    JCheckpointer(str(tmp_path / "ref")).save(3, ref.state_dict())
    tree, meta = AtomicCheckpointer(str(tmp_path / "ref")).restore()
    assert meta["step"] == 3
    port = _port_mlp().build(batches[0][0])
    port.load_state_dict(tree)
    assert port.optimizer.num_update == 3
    for a, b in zip(_port_params(port), ref.params()):
        assert onp.array_equal(a.numpy(), b)
    x, y = batches[3]
    assert float(port.step(x, y)) == pytest.approx(
        float(ref.step((x,), (y,)).asnumpy()), rel=LOSS_RTOL)

    port2 = _port_mlp()
    for x, y in batches[:3]:
        port2.step(x, y)
    AtomicCheckpointer(str(tmp_path / "port")).save(3, port2.state_dict())
    jtree, jmeta = JCheckpointer(str(tmp_path / "port")).restore()
    assert jmeta["step"] == 3
    ref2 = _RefMLP()
    ref2.build((jmx.nd.array(batches[0][0]),), ())
    ref2.load_state_dict(jtree)
    assert ref2.tr.optimizer.num_update == 3
    for a, b in zip(_port_params(port2), ref2.params()):
        assert onp.array_equal(a.numpy(), b)


# --------------------------------------------------------- the loop


def _tiny_gpt2(dropout):
    net = get_gpt2("gpt2_124m", vocab_size=64, units=32, num_layers=2,
                   num_heads=2, max_length=32, dropout=dropout,
                   device="cpu").initialize(seed=0)
    return ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                          optimizer_params={"learning_rate": 1e-2},
                          guard_nonfinite=True,
                          loss_scaler=LossScaler(2.0 ** 10, 2.0, 2000))


def _lm_batches():
    for i in range(100):
        rs = onp.random.RandomState(500 + i)
        yield (rs.randint(0, 64, (4, 16)).astype("int32"),
               rs.randint(0, 64, (4, 16)).astype("int32"))


@pytest.mark.chaos
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_kill_resume_is_bit_identical(tmp_path, dropout):
    """Kills at three distinct ``trainer.step`` hits, one at the commit
    and one retried fault; fresh trainers resume each time and the run
    ends bit-identical to the fault-free one: parameters, optimizer
    state, loss scale, finite-step count and the last loss."""
    steps = 12
    tr = _tiny_gpt2(dropout)
    ref = ResilientLoop(tr, str(tmp_path / "ref"), save_every=4, seed=7,
                        max_to_keep=2).run(_lm_batches, steps)
    want, want_loss = _state(tr), ref["final_loss"]
    plan = (FaultPlan(seed=0)
            .kill_at("trainer.step", at=6)
            .kill_at("trainer.step", at=11)
            .kill_at("trainer.step", at=14)
            .kill_at("checkpoint.commit", at=3)
            .raise_at("trainer.step", at=20, retryable=True))
    kills, report = 0, None
    with plan:
        for _ in range(8):
            loop = ResilientLoop(_tiny_gpt2(dropout), str(tmp_path / "chaos"),
                                 save_every=4, seed=7, max_to_keep=2,
                                 backoff=0.0)
            try:
                report = loop.run(_lm_batches, steps)
                break
            except SimulatedPreemption:
                kills += 1
    assert kills == 4 and plan.fired() == 5
    assert report["completed_steps"] == steps and report["retries"] == 1
    assert report["resumed_from"] == 8
    assert loop.metrics.counters["resumes"] == 1
    assert _same_state(_state(loop.trainer), want)
    assert report["final_loss"] == want_loss


@pytest.mark.chaos
def test_loop_matches_the_reference_loop(tmp_path):
    """The same plan (a retried fault, a gradient poison, a kill) over
    the same MLP and batches: equal report counters and checkpoints,
    losses within tolerance."""
    def plan(cls):
        return (cls(seed=0)
                .raise_at("trainer.step", at=2, retryable=True)
                .nonfinite_at("trainer.grad_nonfinite", at=5)
                .kill_at("trainer.step", at=9))

    def run(make, loop_cls, plan_cls, kill_cls, d):
        reports = []
        with plan(plan_cls):
            for _ in range(3):
                tr = make()
                loop = loop_cls(tr, d, save_every=3, seed=7, max_to_keep=2,
                                backoff=0.0)
                try:
                    reports.append(loop.run(_mlp_batches, 10))
                    break
                except kill_cls:
                    reports.append("killed")
        return reports, loop, tr

    got, ploop, ptr = run(lambda: _port_mlp(guard_nonfinite=True),
                          ResilientLoop, FaultPlan, SimulatedPreemption,
                          str(tmp_path / "port"))
    want, jloop, jtr = run(lambda: _RefMLP(guard_nonfinite=True), JLoop,
                           JPlan, JPreemption, str(tmp_path / "ref"))
    assert [r == "killed" for r in got] == [True, False]
    assert [r == "killed" for r in want] == [True, False]
    g, w = got[-1], want[-1]
    assert g["final_loss"] == pytest.approx(w["final_loss"], rel=LOSS_RTOL)
    g.pop("final_loss"), w.pop("final_loss")
    assert g == w and g["resumed_from"] == 6
    assert ploop.metrics.counters == jloop.metrics.counters
    assert ploop.checkpointer.all_steps() == jloop.checkpointer.all_steps()
    for a, b in zip(_port_params(ptr), jtr.params()):
        onp.testing.assert_allclose(a.numpy(), b, atol=PARAM_TOL, rtol=0)


@pytest.mark.chaos
def test_retry_budget_and_batch_fn(tmp_path):
    loop = ResilientLoop(_port_mlp(), str(tmp_path / "r"), save_every=4,
                         seed=3, max_retries=2, backoff=0.001)
    with FaultPlan().raise_at("trainer.step", at=2, retryable=True) \
            .raise_at("trainer.step", at=5, retryable=True):
        report = loop.run(_mlp_batches, 6)
    assert report["completed_steps"] == 6 and report["retries"] == 2
    zero = ResilientLoop(_port_mlp(), str(tmp_path / "z"), max_retries=0)
    with FaultPlan().raise_at("trainer.step", at=1, retryable=True):
        with pytest.raises(RetryableFault):
            zero.run(_mlp_batches, 2)
    with pytest.raises(mx.MXNetError):
        zero.run(None, 3)
    batches = list(_mlp_batches())
    loop = ResilientLoop(_port_mlp(), str(tmp_path / "b"), seed=1)
    assert loop.run(batch_fn=lambda s: batches[s],
                    steps=3)["completed_steps"] == 3
    assert loop.checkpointer.latest_step() == 3


@pytest.mark.chaos
def test_sigterm_commits_and_resumes(tmp_path):
    loop = ResilientLoop(_port_mlp(), str(tmp_path / "p"), save_every=100,
                         seed=5)
    prev = signal.getsignal(signal.SIGTERM)
    with FaultPlan().call_at("trainer.step", at=4,
                             fn=lambda: os.kill(os.getpid(),
                                                signal.SIGTERM)):
        report = loop.run(_mlp_batches, 10)
    assert report["preempted"] is True and report["completed_steps"] == 4
    assert loop.checkpointer.latest_step() == 4
    assert signal.getsignal(signal.SIGTERM) is prev
    again = ResilientLoop(_port_mlp(), str(tmp_path / "p"), save_every=100,
                          seed=5).run(_mlp_batches, 10)
    assert again["resumed_from"] == 4 and again["completed_steps"] == 10
    assert again["preempted"] is False


class _Recorder:
    """Wraps a trainer's ``step`` to keep each step's finite flag and
    snapshot the state at chosen ``trainer.step`` hits (a ``call_at``
    fires before the step moves anything)."""

    def __init__(self, tr):
        self.tr, self.flags, self.states, self.scales = tr, [], {}, {}
        step = tr.step

        def rec(data, labels):
            out = step(data, labels)
            self.flags.append(bool(out[1]))
            return out
        tr.step = rec

    def at(self, hit):
        def snap():
            self.states[hit] = _state(self.tr)
            self.scales[hit] = self.tr.loss_scale
        return snap


@pytest.mark.chaos
def test_poison_splice_through_the_uncaptured_step(tmp_path):
    """Loss poison at step 3, gradient poison at step 6 (an Inf): each
    poisoned step reports non-finite and leaves every tensor
    bit-identical, the loss scale halves, the next step updates."""
    tr = _tiny_gpt2(0.0)
    rec = _Recorder(tr)
    plan = (FaultPlan()
            .nonfinite_at("trainer.loss_nonfinite", at=3)
            .nonfinite_at("trainer.grad_nonfinite", at=6,
                          value=float("inf")))
    for hit in (3, 4, 6, 7, 8):
        plan.call_at("trainer.step", at=hit, fn=rec.at(hit))
    with plan:
        report = ResilientLoop(tr, str(tmp_path / "x"), save_every=4,
                               seed=7).run(_lm_batches, 8)
    assert rec.flags == [True, True, False, True, True, False, True, True]
    assert report["bad_steps"] == 2
    for hit in (3, 6):
        before, after = rec.states[hit], rec.states[hit + 1]
        moved = {k for k in before if not torch.equal(before[k], after[k])}
        # the step count moves (as the reference's), nothing else but
        # the guard state
        assert moved == {"meta:num_update", "meta:loss_scale",
                         "meta:good_steps"}
        assert rec.scales[hit + 1] == rec.scales[hit] / 2
    assert not torch.equal(rec.states[7]["param:0"],
                           rec.states[8]["param:0"])


@pytest.mark.chaos
def test_bad_step_policies(tmp_path):
    # raise: the first bad step escalates, the state stays intact
    tr = _tiny_gpt2(0.0)
    loop = ResilientLoop(tr, str(tmp_path / "r"), on_bad_step="raise",
                         seed=7)
    with FaultPlan().nonfinite_at("trainer.loss_nonfinite", at=2):
        with pytest.raises(NonFiniteStepError):
            loop.run(_lm_batches, 4)
    # rewind: two poisoned steps in a row after the step-4 commit restore
    # it; the run goes on past the poisoned batches
    tr = _tiny_gpt2(0.0)
    rec = _Recorder(tr)
    loop = ResilientLoop(tr, str(tmp_path / "w"), on_bad_step="rewind",
                         rewind_after=2, save_every=4, seed=7)
    plan = (FaultPlan().nonfinite_at("trainer.loss_nonfinite", at=6)
            .nonfinite_at("trainer.loss_nonfinite", at=7)
            .call_at("trainer.step", at=5, fn=rec.at(5))
            .call_at("trainer.step", at=8, fn=rec.at(8)))
    with plan:
        report = loop.run(_lm_batches, 10)
    assert report["rewinds"] == 1 and report["bad_steps"] == 2
    assert report["completed_steps"] == 10
    # step 5's update is undone: hit 8 starts from the step-4 commit
    committed, _meta = AtomicCheckpointer(str(tmp_path / "w")).restore(4)
    assert _meta["step"] == 4
    for k, v in committed.items():
        if not k.startswith("meta:"):
            assert torch.equal(rec.states[8][k], v), k
    with pytest.raises(mx.MXNetError):
        ResilientLoop(tr, str(tmp_path / "q"), on_bad_step="ignore")
    # rewind with nothing committed escalates
    loop = ResilientLoop(_tiny_gpt2(0.0), str(tmp_path / "n"),
                         on_bad_step="rewind", rewind_after=1,
                         save_every=100)
    with FaultPlan().nonfinite_at("trainer.grad_nonfinite", at=1):
        with pytest.raises(NonFiniteStepError, match="no committed"):
            loop.run(_lm_batches, 3)


def test_trainer_step_site_fires_before_the_count_moves():
    tr = _port_mlp()
    x, y = next(_mlp_batches())
    with FaultPlan().raise_at("trainer.step", at=1):
        with pytest.raises(InjectedFault):
            tr.step(x, y)
    assert not tr._built and tr.optimizer.num_update == 0
    tr.step(x, y)
    assert tr.optimizer.num_update == 1

    class Source:
        last_wait_seconds = 0.25

        def stats(self):
            return {"batches": 1}
    assert tr.attach_data_source(Source()) is tr._data_source
    assert tr.stats()["data"] == {"batches": 1}


def test_watchdog_trips_once():
    from mxnet_tpu_torch.observability import default_registry
    trips = []
    state = {"n": 0}

    def check():
        state["n"] += 1
        return "stalled" if state["n"] >= 3 else None
    wd = Watchdog(check, trips.append, interval=0.005, name="test-wd")
    wd.start()
    wd.join(5)
    assert not wd.is_alive() and trips == ["stalled"] and wd.tripped
    # the registry is the process's: other tests' histograms (samples
    # with buckets, no "value") may sit beside the counter
    samples = {(s["name"], s["labels"].get("watchdog")): s.get("value")
               for s in default_registry().collect()["samples"]}
    assert samples[("mxtpu_watchdog_trips_total", "test-wd")] >= 1
    wd.stop()
