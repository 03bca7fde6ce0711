"""``mxnet_tpu_torch.data``: ``DeviceTransform``, ``DevicePrefetcher``
and ``ShardedLoader`` on the CPU, against the JAX package's where the
contract is the reference's.

- ``DeviceTransform``'s uint8 path equals the host float path (the
  reference's 1e-5 bound; bit for bit here), its lattice counts and
  ``freeze`` equal the reference's, and its crops are deterministic in
  (seed, step) and spread uniformly (chi-square).  The bits of its draws
  are Philox's, not jax's ``fold_in``: a divergence by design.
- ``DevicePrefetcher`` (no streams on the CPU): losses through it are
  bit-identical to synchronous feeding, also through a kill and resume
  under ``ResilientLoop``; ``state_dict`` fast-forwards; both fault sites
  degrade and lose nothing; feeder-kill takeover, ring backpressure and
  the input-wait metric behave as the reference's do.
- The slice as a whole: token records → ``RecordFileDataset`` →
  ``DataLoader`` → ``DevicePrefetcher`` → a small GPT-2 ``ShardedTrainer``
  against the reference's pipeline and trainer on the same records and
  weights (losses relative 1e-5, as ``tests/test_torch_train.py``).
"""
import time

import numpy as onp
import pytest
import torch
from scipy import stats

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import (DevicePrefetcher, DeviceTransform,
                                  ShardedLoader, assemble_global,
                                  host_batch_rows)
from mxnet_tpu_torch.data.prefetch import DataPipelineError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.resilience import (FaultPlan, ResilientLoop,
                                        SimulatedPreemption)

_W1 = onp.random.RandomState(42).randn(16, 6).astype("float32") * 0.1
_W2 = onp.random.RandomState(43).randn(2, 16).astype("float32") * 0.1


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with P.cpu():
        yield


def _make_trainer(**kw):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=6),
            nn.Dense(2, in_units=16))
    net.initialize()
    with torch.no_grad():
        net[0].weight.copy_(torch.from_numpy(_W1))
        net[0].bias.zero_()
        net[1].weight.copy_(torch.from_numpy(_W2))
        net[1].bias.zero_()
    return par.ShardedTrainer(
        net, "adam", loss=gluon.loss.SoftmaxCrossEntropyLoss(),
        optimizer_params={"learning_rate": 0.01}, **kw)


def _batches(n=100):
    for i in range(n):
        rs = onp.random.RandomState(1000 + i)
        X = rs.randn(8, 6).astype("float32")
        y = (X.sum(1) > 0).astype("int32")
        yield (nd.array(X), nd.array(y))


def _params_of(tr):
    return [p.detach().clone() for _, p in tr._trainable]


# ----------------------------------------------------------- DeviceTransform


def test_uint8_device_augment_matches_host_float_path():
    rs = onp.random.RandomState(0)
    x = rs.randint(0, 256, (4, 3, 8, 8)).astype("uint8")
    mean = (123.68, 116.779, 103.939)
    std = (58.393, 57.12, 57.375)
    t = DeviceTransform(mean=mean, std=std, layout="NCHW")
    dev = t.apply(x, step=0).numpy()
    host = (x.astype("float32")
            - onp.asarray(mean, "float32").reshape(1, 3, 1, 1)) \
        / onp.asarray(std, "float32").reshape(1, 3, 1, 1)
    assert dev.dtype == onp.float32
    onp.testing.assert_array_equal(dev, host)
    ref = onp.asarray(R.data.DeviceTransform(
        mean=mean, std=std, layout="NCHW").apply(x, step=0))
    onp.testing.assert_allclose(dev, ref, atol=1e-5, rtol=0)
    # NHWC in, and NCHW in with an NHWC (channels-last) result
    nhwc = t.apply(x, 0).permute(0, 2, 3, 1)
    got = DeviceTransform(mean=mean, std=std, layout="NHWC").apply(
        onp.ascontiguousarray(x.transpose(0, 2, 3, 1)), 0)
    assert torch.equal(got, nhwc)
    cl = DeviceTransform(mean=mean, std=std, layout="NCHW",
                         out_layout="NHWC").apply(x, 0)
    assert cl.is_contiguous() and torch.equal(cl, nhwc)


def test_device_augment_deterministic_and_shape():
    t = DeviceTransform(crop=5, mirror=True, layout="NCHW", seed=9)
    x = onp.random.RandomState(1).randint(
        0, 256, (4, 3, 8, 8)).astype("uint8")
    y1, y2, y3 = t.apply(x, step=3), t.apply(x, step=3), t.apply(x, step=4)
    assert tuple(y1.shape) == (4, 3, 5, 5)
    assert torch.equal(y1, y2)                 # same (seed, step): replay
    assert not torch.equal(y1, y3)             # step moves the augment
    # every output is a window of its own sample, maybe mirrored
    for i in range(4):
        found = False
        for oy in range(4):
            for ox in range(4):
                win = torch.from_numpy(x[i, :, oy:oy + 5, ox:ox + 5]).float()
                found |= torch.equal(y1[i], win) or \
                    torch.equal(y1[i], win.flip(-1))
        assert found
    # a fresh transform with the same seed crops alike (a resume)
    assert torch.equal(DeviceTransform(crop=5, mirror=True, layout="NCHW",
                                       seed=9).apply(x, 3), y1)


def test_crops_and_flips_spread_uniformly():
    """Offsets are uniform over the window's positions and flips fair:
    chi-square over 64 samples x 40 steps (p > 1e-3)."""
    from mxnet_tpu_torch.data.transforms import augment_draws
    oys, oxs, flips = [], [], []
    for step in range(40):
        oy, ox, fl = augment_draws(5, torch.tensor([step]), 64, (7, 5),
                                   torch.device("cpu"))
        oys.append(oy)
        oxs.append(ox)
        flips.append(fl)
    for draws, k in ((torch.cat(oys), 7), (torch.cat(oxs), 5),
                     (torch.cat(flips), 2)):
        counts = torch.bincount(draws, minlength=k).numpy()
        assert counts.size == k and draws.min() >= 0
        assert stats.chisquare(counts).pvalue > 1e-3


def test_transform_compile_freeze_lattice_equals_the_reference():
    def run(mod, to_np):
        t = mod.data.DeviceTransform(mean=(0.0,), std=(1.0,), crop=4,
                                     layout="NHWC")
        a = onp.zeros((2, 6, 6, 1), "uint8")
        b = onp.zeros((4, 6, 6, 1), "uint8")
        t.apply(a, 0)
        t.apply(b, 0)
        counts = [t.compile_count]
        t.freeze()
        t.apply(a, 1)
        t.apply(b, 99)
        counts.append(t.compile_count)
        with pytest.raises(mod.base.MXNetError):
            t.apply(onp.zeros((8, 6, 6, 1), "uint8"), 0)
        return counts, t.stats()

    (rc, rs), (pc, ps) = run(R, onp.asarray), run(P, lambda y: y.numpy())
    assert rc == pc == [2, 2]
    assert rs == ps


def test_transform_rejects_bad_config():
    with pytest.raises(MXNetError):
        DeviceTransform(layout="CHWN")
    with pytest.raises(MXNetError):
        DeviceTransform(crop=0)
    t = DeviceTransform(crop=9)
    with pytest.raises(MXNetError):
        t.apply(onp.zeros((2, 3, 8, 8), "uint8"), 0)
    with pytest.raises(MXNetError):
        t.apply(onp.zeros((3, 8, 8), "uint8"), 0)


def test_prefetcher_applies_transform_hook():
    t = DeviceTransform(mean=(2.0,), std=(4.0,), layout="NCHW")
    xs = [onp.full((2, 1, 3, 3), i, "uint8") for i in range(4)]
    src = iter([(x, onp.zeros(2, "float32")) for x in xs])
    pf = DevicePrefetcher(src, depth=2, transform=t)
    got = [d for d, _ in pf]
    pf.close()
    assert len(got) == 4
    for i, d in enumerate(got):
        assert onp.allclose(d.asnumpy(), (i - 2.0) / 4.0, atol=1e-6)


# ---------------------------------------------------------- prefetch parity


@pytest.mark.parametrize("guard", [False, True])
def test_prefetched_loss_bit_identical_to_sync(guard):
    t_sync = _make_trainer(guard_nonfinite=guard)
    sync_losses = []
    for d, l in _batches(12):
        r = t_sync.step(d, l)
        sync_losses.append(float(r[0] if guard else r))

    t_pf = _make_trainer(guard_nonfinite=guard)
    d0, l0 = next(_batches(1))
    t_pf.build(d0, l0)
    assert t_pf.batch_shardings == [torch.device("cpu")] * 2
    pf = DevicePrefetcher(_batches(12), shardings=t_pf.batch_shardings,
                          depth=2)
    t_pf.attach_data_source(pf)
    pf_losses = []
    try:
        for d, l in pf:
            r = t_pf.step(d, l)
            pf_losses.append(float(r[0] if guard else r))
    finally:
        pf.close()
    assert pf_losses == sync_losses
    st = pf.stats()
    assert st["batches_shipped"] == 12 and st["batches_fallback"] == 0
    assert st["bytes_shipped"] == 12 * (8 * 6 * 4 + 8 * 4)
    tstats = t_pf.stats()
    assert tstats["data"]["consumed"] == 12
    assert tstats["data"]["input_wait_seconds_total"] >= 0.0


def test_input_wait_rides_the_step_span():
    from mxnet_tpu_torch import observability as obs
    tr = _make_trainer()
    pf = DevicePrefetcher(_batches(3), depth=2)
    tr.attach_data_source(pf)
    tracer = obs.enable_tracing()
    try:
        for d, l in pf:
            tr.step(d, l)
        spans = [s for s in tracer.spans() if s.name == "trainer.step"]
    finally:
        obs.disable_tracing()
        pf.close()
    assert len(spans) == 3
    assert all(s.attrs["input_wait"] >= 0.0 for s in spans)


def test_kill_resume_parity_through_resilient_loop(tmp_path):
    STEPS = 10
    tr = _make_trainer()
    loop = ResilientLoop(tr, str(tmp_path / "ref"), save_every=2, seed=7)
    assert loop.run(lambda: _batches(), STEPS)["completed_steps"] == STEPS
    ref = _params_of(tr)

    made = []

    def make_iter():
        made.append(DevicePrefetcher(_batches(), depth=2))
        return made[-1]

    plan = FaultPlan(seed=0).kill_at("trainer.step", at=4)
    kills, report = 0, None
    try:
        with plan:
            for _ in range(3):
                tr2 = _make_trainer()
                loop2 = ResilientLoop(tr2, str(tmp_path / "pf"),
                                      save_every=2, seed=7)
                try:
                    report = loop2.run(make_iter, STEPS)
                    break
                except SimulatedPreemption:
                    kills += 1
    finally:
        for pf in made:
            pf.close()
    assert kills == 1
    assert report is not None and report["completed_steps"] == STEPS
    assert report["resumed_from"] is not None
    for a, b in zip(ref, _params_of(tr2)):
        assert torch.equal(a, b)


def test_state_dict_offset_fast_forward():
    src = list(_batches(20))
    pf = DevicePrefetcher(src, depth=2)
    for _ in range(5):
        pf.next()
    sd = pf.state_dict()
    assert sd == {"offset": 5}
    nxt = pf.next()
    pf.close()
    pf2 = DevicePrefetcher(list(_batches(20)), depth=2)
    pf2.load_state_dict(sd)
    got = pf2.next()
    pf2.close()
    assert onp.array_equal(got[0].asnumpy(), nxt[0].asnumpy())
    assert onp.array_equal(got[1].asnumpy(), nxt[1].asnumpy())
    pf3 = DevicePrefetcher(_batches(5), depth=2)
    with pytest.raises(DataPipelineError):
        pf3.load_state_dict({"offset": 2})
    pf3.close()


# --------------------------------------------------------- fault containment


def test_data_prefetch_fault_degrades_to_sync_batch():
    ref = [x[0] for x in _batches(6)]
    with FaultPlan().raise_at("data.prefetch", every=2):
        pf = DevicePrefetcher(_batches(6), depth=2)
        got = list(pf)
        st = pf.stats()
        pf.close()
    assert len(got) == 6
    for (d, _), r in zip(got, ref):
        assert onp.array_equal(d.asnumpy(), r.asnumpy())
    assert st["batches_fallback"] == 3 and st["batches_shipped"] == 3


def test_data_device_put_fault_retries_then_falls_back():
    with FaultPlan().raise_at("data.device_put", at=1):
        pf = DevicePrefetcher(_batches(3), depth=2)
        got = list(pf)
        st = pf.stats()
        pf.close()
    assert len(got) == 3
    assert st["batches_fallback"] == 0 and st["batches_shipped"] == 3
    ref = [x[0] for x in _batches(3)]
    with FaultPlan().raise_at("data.device_put", at=1).raise_at(
            "data.device_put", at=2):
        pf = DevicePrefetcher(_batches(3), depth=2)
        got = list(pf)
        st = pf.stats()
        pf.close()
    assert len(got) == 3 and st["batches_fallback"] == 1
    for (d, _), r in zip(got, ref):
        assert onp.array_equal(d.asnumpy(), r.asnumpy())


def test_feeder_kill_takeover_loses_nothing():
    from mxnet_tpu_torch.observability import flightrecorder as frmod
    ref = [(d.asnumpy(), l.asnumpy()) for d, l in _batches(8)]
    fr = frmod.enable(capacity=256)
    try:
        with FaultPlan().kill_at("data.prefetch", at=3):
            pf = DevicePrefetcher(_batches(8), depth=2)
            got = list(pf)
            st = pf.stats()
            pf.close()
        events = [e.name for e in fr.events()]
    finally:
        frmod.disable()
    assert len(got) == 8
    for (d, l), (rd, rl) in zip(got, ref):
        assert onp.array_equal(d.asnumpy(), rd)
        assert onp.array_equal(l.asnumpy(), rl)
    assert st["crashed"] == "SimulatedPreemption"
    assert st["feeder_alive"] is False
    assert "data.feeder_crash" in events


def test_stall_event_recorded():
    from mxnet_tpu_torch.observability import flightrecorder as frmod

    def slow():
        yield (onp.zeros((2, 3), "float32"), onp.zeros(2, "float32"))
        time.sleep(0.25)
        yield (onp.ones((2, 3), "float32"), onp.ones(2, "float32"))

    fr = frmod.enable(capacity=64)
    try:
        pf = DevicePrefetcher(slow(), depth=2, stall_timeout=0.05)
        got = list(pf)
        st = pf.stats()
        pf.close()
        events = [e.name for e in fr.events()]
    finally:
        frmod.disable()
    assert len(got) == 2 and st["stalls"] >= 1
    assert "data.stall" in events


def test_ring_backpressure_bounds_memory():
    pulled = []

    class CountingSource:
        batch_size = 4

        def __init__(self):
            self._i = 0

        def next(self):
            if self._i >= 50:
                raise StopIteration
            pulled.append(self._i)
            self._i += 1
            return (onp.full((4, 2), self._i, "float32"),
                    onp.zeros(4, "float32"))

        def reset(self):
            self._i = 0

    depth = 3
    pf = DevicePrefetcher(CountingSource(), depth=depth)
    time.sleep(0.3)
    st = pf.stats()
    assert st["ring_occupancy"] <= depth
    assert len(pulled) <= depth + 1
    assert st["feeder_alive"]
    for _ in range(10):
        pf.next()
        assert pf.stats()["ring_occupancy"] <= depth
    assert len(pulled) <= 10 + depth + 1
    pf.close()


def test_ring_hand_off_under_a_short_switch_interval():
    """The feeder and the consumer share the ring and its counters: with
    the interpreter switching threads every microsecond, 300 batches over
    a ring of 1 arrive once each and in order, and ``fed`` and
    ``consumed`` agree (a lost update would break one of the three)."""
    import sys
    src = [(onp.full((2, 2), i, "float32"), onp.full(2, i, "int32"))
           for i in range(300)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = DevicePrefetcher(src, depth=1)
        got = [int(d.asnumpy()[0, 0]) for d, _l in pf]
        st = pf.stats()
        pf.close()
    finally:
        sys.setswitchinterval(interval)
    assert got == list(range(300))
    assert st["fed"] == st["consumed"] == 300
    assert not pf._thread.is_alive()


def test_prefetcher_rejects_bad_inputs():
    with pytest.raises(DataPipelineError):
        DevicePrefetcher(_batches(2), depth=0)
    with pytest.raises(DataPipelineError):
        DevicePrefetcher(42)
    pf = DevicePrefetcher(iter([("not", "a", "batch", "shape")]))
    with pytest.raises(DataPipelineError):
        pf.next()
    pf.close()
    pf = DevicePrefetcher(_batches(2))
    with pytest.raises(DataPipelineError):
        pf.load_state_dict({"offset": -1})
    pf.close()
    pf = DevicePrefetcher(_batches(2), shardings=["cpu"] * 3)
    with pytest.raises(DataPipelineError, match="3 shardings"):
        pf.next()
    pf.close()


def test_input_wait_metric_registered():
    from mxnet_tpu_torch.observability import default_registry
    pf = DevicePrefetcher(_batches(2), depth=2)
    list(pf)
    pf.close()
    names = {s["name"] for s in default_registry().collect()["samples"]}
    for n in ("mxtpu_data_input_wait_seconds", "mxtpu_data_prefetch_depth",
              "mxtpu_data_batches_shipped_total",
              "mxtpu_data_batches_fallback_total",
              "mxtpu_data_bytes_shipped_total"):
        assert n in names


# ------------------------------------------------------------ ShardedLoader


def _load(ids):
    ids = onp.asarray(ids)
    return ids[:, None] * onp.ones((1, 3), "float32"), ids.astype("float32")


@pytest.mark.parametrize("shuffle", [False, True])
def test_sharded_loader_sequence_equals_the_reference(shuffle):
    def run(mod, **kw):
        sl = mod.data.ShardedLoader(_load, num_samples=18, batch_size=4,
                                    sample_shape=(3,), shuffle=shuffle,
                                    seed=3, epochs=2, **kw)
        out = []
        while True:
            try:
                d, l = sl.next()
            except StopIteration:
                break
            out.append((d.asnumpy(), l.asnumpy()))
        return out, sl.stats(), [list(sl.shard_ids(e, s))
                                 for e in (0, 1) for s in (0, 3)]

    (ra, rs, ri), (pa, ps, pi) = run(R), run(P, data_sharding="cpu",
                                                label_sharding="cpu")
    assert rs == ps and ri == pi and len(ra) == len(pa) == 8
    for (a, b), (c, d) in zip(ra, pa):
        assert onp.array_equal(a, c) and onp.array_equal(b, d)


def test_bad_shard_quarantined_and_skipped():
    ref = ShardedLoader(_load, num_samples=16, batch_size=4,
                        sample_shape=(3,))
    clean = [ref.next() for _ in range(4)]
    with FaultPlan().nonfinite_at("data.bad_shard", at=2):
        sl = ShardedLoader(_load, num_samples=16, batch_size=4,
                           sample_shape=(3,))
        got = []
        while True:
            try:
                got.append(sl.next())
            except StopIteration:
                break
    assert sl.quarantined == 1 and len(got) == 3
    for (d, _), (rd, _) in zip(got, [clean[0], clean[2], clean[3]]):
        assert onp.array_equal(d.asnumpy(), rd.asnumpy())
        assert d.context == P.cpu()


def test_one_device_layout_and_wider_ones_raise():
    """One device takes every row; a layout that is neither a device nor
    a mesh placement raises, and so does a placement that splits the
    batch over tp.  Over a tp mesh every rank of the tp line takes the
    rows of its dp block (mesh placements over ranks:
    ``tests/test_torch_parallel.py``, ``test_torch_tensor_parallel.py``)."""
    from mxnet_tpu_torch import parallel as tpar
    assert host_batch_rows("cpu", (8, 3)) == (0, 8)
    g = assemble_global(onp.ones((8, 3), "float32"), P.cpu(), (8, 3))
    assert g.device.type == "cpu" and tuple(g.shape) == (8, 3)
    with pytest.raises(MXNetError, match="neither one device nor a mesh"):
        host_batch_rows(object(), (8, 3))
    tp = tpar.Mesh(onp.arange(2, dtype=object).reshape(1, 1, 1, 1, 2))
    assert host_batch_rows(tpar.global_batch_sharding(tp, 2), (8, 3)) == \
        (0, 8)
    with pytest.raises(MXNetError, match="split over dp and sp"):
        host_batch_rows(tpar.NamedSharding(tp, tpar.PartitionSpec("tp")),
                        (8, 3))
    with pytest.raises(MXNetError):
        assemble_global(onp.ones((4, 3), "float32"), "cpu", (8, 3), lo=4)


# ------------------------------------------------------------ the whole slice


def test_records_through_the_pipeline_train_like_the_reference(tmp_path):
    """Token records → RecordFileDataset → DataLoader → DevicePrefetcher
    → a small GPT-2's ShardedTrainer, in both packages on the same
    records and weights, against the same batches fed directly."""
    import jax
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.models import get_gpt2 as jget, gpt2_lm_loss as jloss
    from mxnet_tpu_torch.models import get_gpt2 as tget, gpt2_lm_loss
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    cfg = dict(vocab_size=256, units=64, num_layers=2, num_heads=2,
               max_length=64, dropout=0.0)
    B, T, STEPS = 4, 32, 3
    rec, idx = str(tmp_path / "tok.rec"), str(tmp_path / "tok.idx")
    w = P.recordio.MXIndexedRecordIO(idx, rec, "w")
    rs = onp.random.RandomState(0)
    for i in range(B * STEPS):
        w.write_idx(i, P.recordio.pack(
            P.recordio.IRHeader(0, 0.0, i, 0),
            rs.randint(0, 256, T + 1).astype("int32").tobytes()))
    w.close()

    def split(raw):
        toks = onp.frombuffer(mod_unpack(raw)[1], "int32")
        return toks[:-1], toks[1:]

    jn = jget("gpt2_124m", **cfg)
    R.random.seed(0)
    jn.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jn._collect_params_with_prefix().items()}
    mod_unpack = R.recordio.unpack
    jds = R.gluon.data.RecordFileDataset(rec).transform(split)
    jdl = R.gluon.data.DataLoader(jds, batch_size=B)
    mesh = jpar.make_mesh(dp=1, devices=jax.devices()[:1])
    with jpar.use_mesh(mesh):
        jtr = jpar.ShardedTrainer(jn, "adam", loss=jloss,
                                  optimizer_params={"learning_rate": 1e-3})
        jpf = R.data.DevicePrefetcher(jdl, depth=2)
        ref = [float(jtr.step(d, l).asnumpy()) for d, l in jpf]
        jpf.close()

    mod_unpack = P.recordio.unpack
    losses = {}
    for arm in ("pipeline", "resident"):
        tn = load_numpy_params(tget("gpt2_124m", device="cpu", **cfg),
                               params)
        tr = par.ShardedTrainer(tn, "adam", loss=gpt2_lm_loss,
                                optimizer_params={"learning_rate": 1e-3})
        ds = P.gluon.data.RecordFileDataset(rec).transform(split)
        dl = P.gluon.data.DataLoader(ds, batch_size=B, pin_memory=True)
        if arm == "pipeline":
            src = tr.attach_data_source(DevicePrefetcher(dl, depth=2))
        else:
            src = [(d.tensor.clone(), l.tensor.clone()) for d, l in dl]
        losses[arm] = [float(tr.step(d, l)) for d, l in src]
        if arm == "pipeline":
            assert src.stats()["batches_shipped"] == STEPS
            src.close()
    assert losses["pipeline"] == losses["resident"]
    assert len(ref) == STEPS
    onp.testing.assert_allclose(losses["pipeline"], ref, rtol=1e-5)


def test_transform_leaves_its_input_as_it_was():
    """The normalize runs in place on the transform's own copy: a float
    batch the caller passes in (no crop, same dtype) is not rewritten."""
    x = torch.from_numpy(onp.random.RandomState(2).uniform(
        0, 255, (2, 4, 4, 3)).astype("float32"))
    before = x.clone()
    y = DeviceTransform(mean=(1.0, 2.0, 3.0), std=(2.0, 4.0, 8.0),
                        layout="NHWC").apply(x, 0)
    assert torch.equal(x, before)
    want = (before - torch.tensor([1.0, 2.0, 3.0])) / torch.tensor(
        [2.0, 4.0, 8.0])
    assert torch.equal(y, want)
