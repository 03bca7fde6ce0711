"""The port's KVStore and ``dist_sync`` Gluon training against the JAX
package's.

In one process both stores take the same pushes (lists of values, as
several devices push in MXNet): sums, ``pushpull``, 2-bit compression
with error feedback, ``update_on_kvstore`` and ``dist_async``'s one
update per pushed value.  Across two gloo processes
(``torch_dist_worker.py``, scenario ``kvstore``), each rank trains the
same MLP (16 -> 32 -> 8, SGD with momentum) on its half of each global
batch of 8 through ``gluon.Trainer(kvstore='dist_sync')``, which sums
the ranks' gradients, so its parameters must equal the reference's
one-process Gluon loop over the whole batch.

Tolerances: 1e-6 on the store's sums and updates (one float32 add or
update apart); 1e-5 on the MLP's parameters after 3 steps (float32
gradients summed over two ranks instead of one batch).
"""
import os

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import optimizer as topt

import torch_dist_worker as W

STORE_TOL = 1e-6
MLP_TOL = 1e-5


def _vals(seed, n=2, shape=(3, 4)):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*shape).astype("float32") for _ in range(n)]


def _stores(kind, **opt):
    j, t = jkv.create(kind), tkv.create(kind)
    if opt:
        j.set_optimizer(jopt.create("sgd", **opt))
        t.set_optimizer(topt.create("sgd", **opt))
    return j, t


def _jnd(a):
    return mx.nd.array(a)


def _tnd(a):
    return tmx.nd.array(a, ctx=tmx.cpu())


@pytest.mark.parametrize("kind,opt,compression", [
    ("local", {}, None),
    ("device", {}, {"type": "2bit", "threshold": 0.5}),
    ("local", {"learning_rate": 0.1, "momentum": 0.9}, None),
    ("dist_async", {"learning_rate": 0.1}, None),
    ("dist_sync", {"learning_rate": 0.1, "momentum": 0.9},
     {"type": "2bit", "threshold": 0.3}),
])
def test_store_matches_reference(kind, opt, compression):
    j, t = _stores(kind, **opt)
    if compression:
        j.set_gradient_compression(compression)
        t.set_gradient_compression(compression)
    w0 = _vals(0, 1)[0]
    j.init("w", _jnd(w0))
    t.init("w", _tnd(w0))
    jo, to = _jnd(onp.zeros_like(w0)), _tnd(onp.zeros_like(w0))
    for step in range(3):
        vals = _vals(step + 1)
        j.push("w", [_jnd(v) for v in vals])
        t.push("w", [_tnd(v) for v in vals])
        j.pull("w", out=jo)
        t.pull("w", out=to)
        onp.testing.assert_allclose(to.asnumpy(), jo.asnumpy(),
                                    atol=STORE_TOL, rtol=0)
    # the fused form: one reduce, the result into out
    vals = _vals(9)
    j.pushpull("w", [_jnd(v) for v in vals], out=jo)
    t.pushpull("w", [_tnd(v) for v in vals], out=to)
    onp.testing.assert_allclose(to.asnumpy(), jo.asnumpy(),
                                atol=STORE_TOL, rtol=0)


def test_identity_registry_and_optimizer_states(tmp_path):
    t = tkv.create("dist_sync")
    assert (t.type, t.rank, t.num_workers) == ("dist_sync", 0, 1)
    with pytest.raises(Exception):
        tkv.create("no_such_store")
    with pytest.raises(tmx.MXNetError, match="2bit"):
        t.set_gradient_compression({"type": "1bit"})
    with pytest.raises(tmx.MXNetError, match="no optimizer"):
        t.save_optimizer_states(str(tmp_path / "s"))

    @tkv.KVStoreBase.register
    class CustomStore(tkv.KVStoreBase):
        pass
    assert type(tkv.create("CustomStore")) is CustomStore
    # optimizer states round-trip through the store
    j, t = _stores("local", learning_rate=0.1, momentum=0.9)
    t.init(0, _tnd(onp.ones(3, "float32")))
    t.push(0, _tnd(onp.full(3, 0.5, "float32")))
    t.save_optimizer_states(str(tmp_path / "s"))
    t2 = tkv.create("local")
    t2.set_optimizer(topt.create("sgd", learning_rate=0.1, momentum=0.9))
    t2.load_optimizer_states(str(tmp_path / "s"))
    assert set(t2.updater.states) == {0}
    # the fleet counters move with the traffic, as the reference's
    pushes, pulls = t._obs_push.value, t._obs_pull.value
    t.push(0, _tnd(onp.zeros(3, "float32")))
    t.pull(0, out=_tnd(onp.zeros(3, "float32")))
    assert (t._obs_push.value, t._obs_pull.value) == (pushes + 1,
                                                       pulls + 1)
    assert t._obs_push.name == "mxtpu_kvstore_push_total"


def test_gluon_trainer_takes_the_kvstore_arguments():
    from mxnet_tpu_torch.gluon import nn
    with tmx.cpu():
        net = nn.Dense(2, in_units=3)
        net.initialize()
        for kw in (dict(kvstore="dist_sync"), dict(kvstore="nccl"),
                   dict(kvstore="dist_sync", update_on_kvstore=True),
                   dict(kvstore="dist_sync",
                        compression_params={"type": "2bit"})):
            tmx.gluon.Trainer(net.collect_params(), "sgd", **kw)
        with pytest.raises(Exception):
            tmx.gluon.Trainer(net.collect_params(), "sgd",
                              kvstore="dist_device_sync")


# ------------------------------------------------------- two processes


def _ref_mlp_params():
    net = jnn.HybridSequential()
    net.add(jnn.Dense(32, activation="relu", in_units=16),
            jnn.Dense(8, in_units=32))
    mx.random.seed(0)
    net.initialize()
    return net, {k: p.data().asnumpy()
                 for k, p in net._collect_params_with_prefix().items()}


EMB_TABLE = onp.random.RandomState(12).randn(40, 4).astype("float32")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("kvstore")
    _net, params = _ref_mlp_params()
    onp.savez(os.path.join(d, "mlp.npz"), **params)
    onp.savez(os.path.join(d, "emb.npz"), table=EMB_TABLE)
    return params, W.launch(2, "kvstore", d)


@pytest.fixture(scope="module")
def ref_mlp(run):
    out = {}
    for uok in (False, True):
        net, _p = _ref_mlp_params()
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(run[0][k]))
        tr = jgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore="device", update_on_kvstore=uok)
        loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in W.mlp_batches():
            with jag.record():
                loss = loss_fn(net(mx.nd.array(x)),
                               mx.nd.array(y, dtype="int32"))
            loss.backward()
            tr.step(W.MLP_B)
        out[uok] = {k: p.data().asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}
    return out


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("tag,uok", [("sync", False), ("sync_uok", True)])
def test_dist_sync_gluon_training_matches_the_whole_batch(run, ref_mlp,
                                                          rank, tag, uok):
    out = run[1][rank]
    for k, v in ref_mlp[uok].items():
        onp.testing.assert_allclose(out[f"{tag}:param:{k}"], v,
                                    atol=MLP_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("tag", ["sparse", "sparse_uok"])
def test_dist_sync_sparse_embedding_matches_the_whole_batch(run, rank, tag):
    """Row-sparse gradients under ``dist_sync`` on two gloo ranks (each
    rank half the batch, summed over the ranks in their dense form)
    train the table as the reference's sparse embedding does on the
    whole batch in one process (SGD)."""
    net = jnn.Embedding(*EMB_TABLE.shape, sparse_grad=True)
    net.initialize()
    net.weight.set_data(mx.nd.array(EMB_TABLE))
    tr = jgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    for ids in W.emb_batches():
        with jag.record():
            (net(mx.nd.array(ids, dtype="int32")) ** 2).sum().backward()
        tr.step(len(ids))
    onp.testing.assert_allclose(run[1][rank][f"{tag}:table"],
                                net.weight.data().asnumpy(), atol=MLP_TOL,
                                rtol=0)


def test_compressed_and_async_stores_agree_across_ranks(run, ref_mlp):
    r0, r1 = run[1]
    for k in ref_mlp[False]:
        # every rank applies the same quantized sums
        assert onp.array_equal(r0[f"sync_2bit:param:{k}"],
                               r1[f"sync_2bit:param:{k}"])
    assert any(not onp.allclose(r0[f"sync_2bit:param:{k}"], v)
               for k, v in ref_mlp[False].items())
    # dist_async: 0 - 0.5 * 1 - 0.5 * 2 on every rank
    for r in (r0, r1):
        onp.testing.assert_allclose(r["async"], onp.full(3, -1.5))
    assert list(r0["rank_workers"]) == [0, 2]
    assert list(r1["rank_workers"]) == [1, 2]
