"""Sparse storage of the port against the JAX package's, on the CPU.

The cases of ``tests/test_sparse.py`` (CSR and row-sparse arrays,
``cast_storage``, ``sparse.dot`` and its gradient, ``retain``,
``sparse_add``, ``Embedding(sparse_grad=True)``'s compact gradient, the
optimizers' lazy row update, ``KVStore.row_sparse_pull``), each held to
the reference's values on the same seeded numpy inputs, plus the lazy
update's subproblem identity for every optimizer and a Gluon step of a
sparse embedding against the reference's.  Tolerances: float32
round-off, 1e-6 relative unless stated.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu.ndarray import sparse as rsp
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray import sparse


@pytest.fixture(autouse=True)
def _on_cpu():
    with P.cpu():
        yield


def _rand_csr(shape, density, seed=0):
    rs = onp.random.RandomState(seed)
    dense = rs.randn(*shape).astype("float32")
    dense[rs.rand(*shape) > density] = 0.0
    return dense


def _idx(a):
    return a._sp_indices.tolist()


def _weight(block):
    return block.collect_params()["weight"]


# ------------------------------------------------------------ storage

def test_csr_roundtrip():
    dense = _rand_csr((6, 8), 0.3)
    a = sparse.csr_matrix(dense)
    r = rsp.csr_matrix(dense)
    assert a.stype == "csr" and a._data is None
    for comp in ("data", "indices", "indptr"):
        onp.testing.assert_array_equal(getattr(a, comp).asnumpy(),
                                       getattr(r, comp).asnumpy())
    onp.testing.assert_array_equal(a.todense().asnumpy(), dense)
    onp.testing.assert_array_equal(a.asnumpy(), dense)
    b = sparse.csr_matrix((a.data, a.indices, a.indptr), shape=(6, 8))
    onp.testing.assert_array_equal(b.asnumpy(), dense)


def test_row_sparse_roundtrip():
    dense = onp.zeros((8, 4), "float32")
    dense[2] = 1.0
    dense[5] = [1, 2, 3, 4]
    a = sparse.row_sparse_array(dense)
    assert a.stype == "row_sparse" and a._data is None
    assert a.indices.asnumpy().tolist() == \
        rsp.row_sparse_array(dense).indices.asnumpy().tolist() == [2, 5]
    onp.testing.assert_array_equal(a.todense().asnumpy(), dense)
    b = sparse.row_sparse_array((onp.ones((2, 4), "f"), [1, 6]),
                                shape=(8, 4))
    assert b.shape == (8, 4) and b.asnumpy()[[1, 6]].sum() == 8


def test_cast_storage():
    dense = _rand_csr((5, 5), 0.4, seed=1)
    d = nd.array(dense)
    assert d.stype == "default" and d.tostype("default") is d
    c = nd.cast_storage(d, "csr")
    assert c.stype == "csr"
    onp.testing.assert_array_equal(c.asnumpy(), dense)
    r = d.tostype("row_sparse")
    assert r.stype == "row_sparse"
    want = rsp.cast_storage(R.nd.array(dense), "row_sparse")
    assert _idx(r) == onp.asarray(want._sp_indices).tolist()
    back = sparse.cast_storage(c, "default")
    assert back.stype == "default"
    onp.testing.assert_array_equal(back.asnumpy(), dense)


def test_sparse_zeros():
    for st in ("csr", "row_sparse"):
        z = sparse.zeros(st, (4, 5))
        assert z.stype == st and z._sp_data.shape[0] == 0
        onp.testing.assert_array_equal(z.asnumpy(), onp.zeros((4, 5)))
        assert sparse.empty(st, (4, 5)).shape == (4, 5)
    assert sparse.zeros("default", (2, 3)).stype == "default"


def test_cast_storage_csr_row_sparse_both_directions():
    dense = _rand_csr((6, 5), 0.4, seed=7)
    c = sparse.cast_storage(nd.array(dense), "csr")
    r = sparse.cast_storage(c, "row_sparse")
    assert r.stype == "row_sparse"
    onp.testing.assert_array_equal(r.asnumpy(), dense)
    nz_rows = onp.nonzero((dense != 0).any(axis=1))[0]
    assert _idx(r) == nz_rows.tolist()
    c2 = sparse.cast_storage(r, "csr")
    assert c2.stype == "csr"
    onp.testing.assert_array_equal(c2.asnumpy(), dense)
    back = sparse.cast_storage(r, "default")
    onp.testing.assert_array_equal(back.asnumpy(), dense)


def test_cast_storage_empty_and_dtype():
    z = nd.array(onp.zeros((3, 4), "float32"))
    c = sparse.cast_storage(z, "csr")
    assert c._sp_data.shape[0] == 0
    r = sparse.cast_storage(c, "row_sparse")
    assert r._sp_data.shape[0] == 0
    onp.testing.assert_array_equal(r.asnumpy(), onp.zeros((3, 4)))
    d16 = _rand_csr((4, 4), 0.5, seed=8).astype("float16")
    c16 = sparse.cast_storage(nd.array(d16, dtype="float16"), "csr")
    assert c16.dtype == onp.dtype("float16")
    assert sparse.cast_storage(c16, "row_sparse").dtype == \
        onp.dtype("float16")


def test_tostype_matrix():
    dense = _rand_csr((5, 6), 0.4, seed=9)
    c = sparse.csr_matrix(dense)
    assert c.tostype("csr") is c
    r = c.tostype("row_sparse")
    onp.testing.assert_array_equal(r.asnumpy(), dense)
    d = r.tostype("default")
    assert d.stype == "default"
    onp.testing.assert_array_equal(d.asnumpy(), dense)


def test_metadata_does_not_materialize():
    r = sparse.row_sparse_array((onp.ones((2, 8), "f"), [1, 2]),
                                shape=(30000, 8))
    assert (r.shape, r.dtype, r.size, r.ndim, r.context) == \
        ((30000, 8), onp.dtype("float32"), 240000, 2, P.cpu())
    assert r._data is None


def test_retain():
    dense = onp.zeros((6, 3), "float32")
    dense[1], dense[3], dense[4] = 1, 2, 3
    a = sparse.row_sparse_array(dense)
    kept = sparse.retain(a, nd.array([1, 4], dtype="int64"))
    assert _idx(kept) == [1, 4]
    want = dense.copy()
    want[3] = 0
    onp.testing.assert_array_equal(kept.todense().asnumpy(), want)


def test_sparse_add_row_sparse_stays_compact():
    a = sparse.row_sparse_array(
        (onp.ones((2, 3), "f"), onp.array([1, 4])), shape=(8, 3))
    b = sparse.row_sparse_array(
        (2 * onp.ones((2, 3), "f"), onp.array([4, 6])), shape=(8, 3))
    c = sparse.sparse_add(a, b)
    assert isinstance(c, sparse.RowSparseNDArray) and c._data is None
    assert _idx(c) == [1, 4, 6]
    onp.testing.assert_array_equal(c.asnumpy(), a.asnumpy() + b.asnumpy())
    d = sparse.sparse_add(a, nd.array(onp.ones((8, 3), "f")))
    assert d.stype == "default"


# ---------------------------------------------------------------- dot

@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_dense_matches_the_reference(transpose_a):
    dense = _rand_csr((6, 10), 0.3, seed=2)
    rhs = onp.random.RandomState(3).randn(6 if transpose_a else 10,
                                          7).astype("float32")
    got = sparse.dot(sparse.csr_matrix(dense), nd.array(rhs),
                     transpose_a=transpose_a).asnumpy()
    want = rsp.dot(rsp.csr_matrix(dense), R.nd.array(rhs),
                   transpose_a=transpose_a).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(got, (dense.T if transpose_a else dense)
                                @ rhs, rtol=1e-5, atol=1e-5)


def test_csr_dot_empty():
    out = sparse.dot(sparse.zeros("csr", (3, 4)),
                     nd.array(onp.ones((4, 2), "float32")))
    onp.testing.assert_array_equal(out.asnumpy(), onp.zeros((3, 2)))


def _no_densify(monkeypatch):
    """Any dense build of a sparse array in the patched scope fails."""
    def boom(self):
        raise AssertionError("sparse array was densified on the hot path")
    monkeypatch.setattr(sparse.CSRNDArray, "_materialize", boom)
    monkeypatch.setattr(sparse.RowSparseNDArray, "_materialize", boom)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_grad_matches_the_reference(transpose_a, monkeypatch):
    """The dense operand's gradient through csr · dense (and csrᵀ ·
    dense) against the reference's tape, without densifying the csr."""
    dense = _rand_csr((5, 7), 0.4, seed=11)
    w_np = onp.random.RandomState(12).randn(5 if transpose_a else 7,
                                            3).astype("float32")
    a = sparse.csr_matrix(dense)
    w = nd.array(w_np)
    w.attach_grad()
    _no_densify(monkeypatch)
    with autograd.record():
        y = sparse.dot(a, w, transpose_a=transpose_a)
        (y * y).sum().backward()
    rw = R.nd.array(w_np)
    rw.attach_grad()
    with R.autograd.record():
        ry = rsp.dot(rsp.csr_matrix(dense), rw, transpose_a=transpose_a)
        (ry * ry).sum().backward()
    onp.testing.assert_allclose(w.grad.asnumpy(), rw.grad.asnumpy(),
                                rtol=1e-5, atol=1e-5)


def test_csr_dot_empty_batch_stays_on_tape():
    w = nd.array(onp.ones((6, 2), "float32"))
    w.attach_grad()
    with autograd.record():
        y = sparse.dot(sparse.zeros("csr", (4, 6)), w)
        (y * y).sum().backward()
    onp.testing.assert_array_equal(y.asnumpy(), onp.zeros((4, 2)))
    onp.testing.assert_array_equal(w.grad.asnumpy(), onp.zeros((6, 2)))


# ------------------------------------------------- row-sparse gradients

def _emb_pair(V, D, seed=0, sparse_grad=True):
    """The port's and the reference's Embedding from one seeded table."""
    table = onp.random.RandomState(seed).randn(V, D).astype("float32")
    pe = nn.Embedding(V, D, sparse_grad=sparse_grad)
    pe.initialize()
    _weight(pe).set_data(nd.array(table))
    re = R.gluon.nn.Embedding(V, D, sparse_grad=sparse_grad)
    re.initialize()
    re.weight.set_data(R.nd.array(table))
    return pe, re, table


def test_embedding_sparse_grad_is_row_sparse_and_compact():
    V, D = 50000, 16
    pe, re, _ = _emb_pair(V, D)
    ids = onp.array([[3, 7, 3], [9, 7, 1]])
    with autograd.record():
        (pe(nd.array(ids, dtype="int32")) ** 2).sum().backward()
    with R.autograd.record():
        (re(R.nd.array(ids, dtype="int32")) ** 2).sum().backward()
    g, rg = _weight(pe).grad(), re.weight.grad()
    assert isinstance(g, sparse.RowSparseNDArray) and g._data is None
    assert _idx(g) == onp.asarray(rg._sp_indices).tolist() == [1, 3, 7, 9]
    assert tuple(g._sp_data.shape) == (4, D)
    onp.testing.assert_allclose(g._sp_data.numpy(),
                                onp.asarray(rg._sp_data), rtol=1e-6)


def test_tied_embedding_lookups_accumulate_row_sparse():
    V, D = 1000, 4
    pe, re, table = _emb_pair(V, D, seed=1)
    x1, x2 = onp.array([1, 2]), onp.array([2, 5])
    with autograd.record():
        loss = (pe(nd.array(x1, dtype="int32")) ** 2).sum() + \
            (3 * pe(nd.array(x2, dtype="int32"))).sum()
    loss.backward()
    g = _weight(pe).grad()
    assert isinstance(g, sparse.RowSparseNDArray) and _idx(g) == [1, 2, 5]
    want = onp.stack([2 * table[1], 2 * table[2] + 3,
                      onp.full((D,), 3.0, "float32")])
    onp.testing.assert_allclose(g._sp_data.numpy(), want, rtol=1e-6)


def test_sparse_then_dense_gradient_adds_up_dense():
    """A dense use of a sparse-grad weight in the same loss makes the
    gradient dense (every row), as the reference's tape adds a sparse and
    a dense cotangent."""
    pe, re, table = _emb_pair(20, 3, seed=2)
    w = _weight(pe)
    with autograd.record():
        loss = (pe(nd.array([4, 4], dtype="int32")) ** 2).sum() + \
            (w.data() * 2.0).sum()
    loss.backward()
    g = w.grad()
    assert isinstance(g, sparse.RowSparseNDArray)
    assert g._sp_indices.numel() == 20
    want = onp.full((20, 3), 2.0, "float32")
    want[4] += 4 * table[4]
    onp.testing.assert_allclose(g.asnumpy(), want, rtol=1e-6)


def test_kvstore_row_sparse_pull_compact():
    kv = P.kv.create("local")
    full = onp.random.RandomState(0).randn(1000, 8).astype("float32")
    kv.init(3, nd.array(full))
    out = sparse.zeros("row_sparse", (1000, 8))
    kv.row_sparse_pull(3, out=out, row_ids=nd.array([17, 4, 17, 901]))
    assert out._data is None and _idx(out) == [4, 17, 901]
    onp.testing.assert_array_equal(out._sp_data.numpy(),
                                   full[[4, 17, 901]])
    dense_out = nd.zeros((1000, 8))
    kv.row_sparse_pull(3, out=dense_out, row_ids=nd.array([1]))
    onp.testing.assert_array_equal(dense_out.asnumpy(), full)


def test_row_sparse_pull_rejects_out_of_range():
    kv = P.kv.create("local")
    kv.init(9, nd.array(onp.zeros((10, 2), "float32")))
    out = sparse.zeros("row_sparse", (10, 2))
    for bad in ([99], [-1]):
        with pytest.raises(P.MXNetError):
            kv.row_sparse_pull(9, out=out, row_ids=nd.array(bad))


def test_sparse_grad_zero_grad_stays_compact():
    emb = nn.Embedding(100, 4, sparse_grad=True)
    emb.initialize()
    x = nd.array(onp.array([5, 6]), dtype="int32")
    with autograd.record():
        (emb(x) ** 2).sum().backward()
    _weight(emb).zero_grad()
    g = _weight(emb).grad()
    assert g._data is None and g._sp_data.shape[0] == 0
    with autograd.record():
        (emb(x) ** 2).sum().backward()
    assert _idx(_weight(emb).grad()) == [5, 6]


def test_embedding_sparse_grad_dense_fallback_under_hybridize():
    """Under ``hybridize`` the block runs as a compiled program and the
    gradient is dense, as the reference's is under a trace."""
    emb = nn.Embedding(100, 4, sparse_grad=True)
    emb.initialize()
    emb.hybridize()
    with autograd.record():
        (emb(nd.array(onp.array([5, 6]), dtype="int32")) ** 2).sum()\
            .backward()
    g = _weight(emb).grad().asnumpy()
    assert onp.abs(g[5]).sum() > 0 and onp.abs(g[6]).sum() > 0
    assert onp.abs(g[7]).sum() == 0


def test_sparse_grad_buffer_updated_in_place():
    emb = nn.Embedding(100, 4, sparse_grad=True)
    emb.initialize()
    handle = _weight(emb).grad()
    with autograd.record():
        (emb(nd.array(onp.array([3, 9]), dtype="int32")) ** 2).sum()\
            .backward()
    assert handle is _weight(emb).grad() and _idx(handle) == [3, 9]


def test_grad_add_mixed_sparse_then_dense_accumulates():
    """grad_req='add': a dense gradient (a hybridized call) after a
    row-sparse one (an eager call) accumulates, as the reference's."""
    emb = nn.Embedding(50, 4, sparse_grad=True)
    emb.initialize()
    _weight(emb).grad_req = "add"
    x = nd.array(onp.array([7, 8]), dtype="int32")
    with autograd.record():
        emb(x).sum().backward()
    s1 = float(onp.abs(_weight(emb).grad().asnumpy()).sum())
    with autograd.record():
        emb(x).sum().backward()
    assert _weight(emb).grad()._data is None         # still compact
    emb.hybridize()
    with autograd.record():
        emb(x).sum().backward()
    s3 = float(onp.abs(_weight(emb).grad().asnumpy()).sum())
    assert s3 == pytest.approx(3 * s1, rel=1e-5)


def test_attach_grad_row_sparse_and_autograd_grad():
    w = nd.array(onp.random.RandomState(3).randn(10, 2).astype("f"))
    w.attach_grad(stype="row_sparse")
    assert isinstance(w.grad, sparse.RowSparseNDArray) and \
        w.grad._sp_indices.numel() == 0
    ids = nd.array([2, 2, 7], dtype="int32")
    with autograd.record():
        nd.Embedding(ids, w, 10, 2, sparse_grad=True).sum().backward()
    assert _idx(w.grad) == [2, 7]
    onp.testing.assert_array_equal(w.grad._sp_data.numpy(),
                                   [[2, 2], [1, 1]])
    v = nd.array(onp.ones((10, 2), "f"))
    v.attach_grad()
    with autograd.record():
        y = nd.Embedding(ids, v, 10, 2, sparse_grad=True).sum()
    (g,) = autograd.grad(y, [v])
    assert isinstance(g, sparse.RowSparseNDArray) and _idx(g) == [2, 7]


def test_parameter_storage_types():
    p = P.gluon.Parameter("w", shape=(4, 2), grad_stype="row_sparse")
    p.initialize(ctx=P.cpu())
    assert (p.stype, p.grad_stype) == ("default", "row_sparse")
    assert isinstance(p.grad(), sparse.RowSparseNDArray)
    with pytest.raises(P.MXNetError):
        P.gluon.Parameter("w", shape=(2,), stype="bogus")


# ---------------------------------------------------- lazy row update

def test_lazy_sparse_sgd_update():
    from mxnet_tpu_torch.optimizer import SGD, get_updater
    w = nd.array(onp.ones((6, 2), "float32"))
    gdense = onp.zeros((6, 2), "float32")
    gdense[1], gdense[4] = 1.0, 2.0
    grad = sparse.row_sparse_array(gdense)
    upd = get_updater(SGD(learning_rate=0.5, momentum=0.9))
    upd(0, grad, w)
    want = onp.ones((6, 2), "float32")
    want[1] -= 0.5
    want[4] -= 1.0
    onp.testing.assert_allclose(w.asnumpy(), want)
    mom = upd.states[0].numpy()
    assert (mom[0] == 0).all() and (mom[2] == 0).all() and \
        (mom[1] != 0).all()
    upd(0, grad, w)
    w2 = w.asnumpy()
    assert onp.allclose(w2[0], 1.0) and w2[1][0] < want[1][0]


def test_lazy_sparse_adam_update():
    from mxnet_tpu_torch.optimizer import Adam, get_updater
    w = nd.array(onp.ones((5, 3), "float32"))
    gdense = onp.zeros((5, 3), "float32")
    gdense[2] = 1.0
    upd = get_updater(Adam(learning_rate=0.1))
    upd(0, sparse.row_sparse_array(gdense), w)
    out = w.asnumpy()
    assert onp.allclose(out[0], 1.0) and onp.allclose(out[4], 1.0)
    assert not onp.allclose(out[2], 1.0)


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.1}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("ftrl", {"learning_rate": 0.1}),
])
def test_lazy_update_matches_compact_subproblem(name, kwargs, monkeypatch):
    """The lazy row update equals the same optimizer on the compact
    (touched rows only) dense subproblem, with untouched rows
    bit-identical and nothing densified; and the port's weights and
    states equal the reference's lazy update's."""
    from mxnet_tpu.optimizer import create as rcreate, get_updater as rget
    from mxnet_tpu_torch.optimizer import create, get_updater
    V, D = 12, 3
    rs = onp.random.RandomState(0)
    w_full = rs.randn(V, D).astype("float32")
    rows = onp.array([2, 5, 9])
    w, w_sub, rw = nd.array(w_full), nd.array(w_full[rows]), \
        R.nd.array(w_full)
    upd, upd_sub = get_updater(create(name, **kwargs)), \
        get_updater(create(name, **kwargs))
    rupd = rget(rcreate(name, **kwargs))
    _no_densify(monkeypatch)
    for _ in range(4):
        g = rs.randn(len(rows), D).astype("float32")
        upd(0, sparse.row_sparse_array((g, rows), shape=(V, D)), w)
        upd_sub(0, nd.array(g), w_sub)
        rupd(0, rsp.row_sparse_array((g, rows), shape=(V, D)), rw)
    out = w.asnumpy()
    onp.testing.assert_allclose(out[rows], w_sub.asnumpy(), rtol=1e-6,
                                atol=1e-7)
    untouched = onp.setdiff1d(onp.arange(V), rows)
    onp.testing.assert_array_equal(out[untouched], w_full[untouched])
    onp.testing.assert_allclose(out, rw.asnumpy(), rtol=1e-5, atol=1e-6)

    def flat(s):
        if s is None:
            return []
        if isinstance(s, (tuple, list)):
            return [x for v in s for x in flat(v)]
        return [s.asnumpy() if hasattr(s, "asnumpy") else
                s.detach().numpy()]
    for a, b in zip(flat(upd.states[0]), flat(rupd.states[0])):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_lazy_adam_untouched_rows_skip_state_decay(monkeypatch):
    from mxnet_tpu_torch.optimizer import Adam, get_updater
    V, D = 8, 2
    w = nd.array(onp.ones((V, D), "float32"))
    upd = get_updater(Adam(learning_rate=0.1))
    _no_densify(monkeypatch)
    g1 = onp.ones((2, D), "float32")
    upd(0, sparse.row_sparse_array((g1, [1, 3]), shape=(V, D)), w)
    w1 = w.asnumpy().copy()
    m1, v1 = (s.numpy().copy() for s in upd.states[0])
    upd(0, sparse.row_sparse_array((g1, [4, 6]), shape=(V, D)), w)
    out = w.asnumpy()
    onp.testing.assert_array_equal(out[[1, 3]], w1[[1, 3]])
    onp.testing.assert_array_equal(upd.states[0][0].numpy()[[1, 3]],
                                   m1[[1, 3]])
    onp.testing.assert_array_equal(upd.states[0][1].numpy()[[1, 3]],
                                   v1[[1, 3]])
    assert not onp.allclose(out[[4, 6]], w1[[4, 6]])


def test_lazy_update_off_reads_the_dense_gradient():
    from mxnet_tpu_torch.optimizer import Adam, get_updater
    w = nd.array(onp.ones((4, 2), "float32"))
    upd = get_updater(Adam(learning_rate=0.1, lazy_update=False))
    upd(0, sparse.row_sparse_array((onp.ones((1, 2), "f"), [1]),
                                   shape=(4, 2)), w)
    upd(0, sparse.row_sparse_array((onp.ones((1, 2), "f"), [2]),
                                   shape=(4, 2)), w)
    # the dense step decays row 1's state at step 2: it moves again
    assert not onp.allclose(w.asnumpy()[1], w.asnumpy()[3])
    assert upd.states[0][0].numpy()[1].sum() != 0


@pytest.mark.parametrize("opt", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.05}),
])
def test_sparse_embedding_trainer_steps_match_the_reference(opt):
    """Three Gluon ``Trainer`` steps of a sparse-grad embedding: the
    port's weights equal the reference's and the port's own dense arm
    (SGD), untouched rows bit-identical, the gradient never densified."""
    name, kw = opt
    V, D = 20000, 8
    pe, re, table = _emb_pair(V, D, seed=4)
    pd, _, _ = _emb_pair(V, D, seed=4, sparse_grad=False)
    x = onp.array([[11, 4999, 11, 0]])
    trainers = [P.gluon.Trainer(b.collect_params(), name, dict(kw))
                for b in (pe, pd)]
    rtr = R.gluon.Trainer(re.collect_params(), name, dict(kw))
    for _ in range(3):
        for b, tr in zip((pe, pd), trainers):
            with autograd.record():
                (b(nd.array(x, dtype="int32")) ** 2).sum().backward()
            tr.step(1)
        with R.autograd.record():
            (re(R.nd.array(x, dtype="int32")) ** 2).sum().backward()
        rtr.step(1)
    w = _weight(pe).data().asnumpy()
    onp.testing.assert_allclose(w, re.weight.data().asnumpy(), rtol=1e-5,
                                atol=1e-6)
    if name == "sgd":
        onp.testing.assert_allclose(w, _weight(pd).data().asnumpy(),
                                    rtol=1e-5, atol=1e-6)
    untouched = onp.setdiff1d(onp.arange(V), [0, 11, 4999])[:200]
    onp.testing.assert_array_equal(w[untouched], table[untouched])
    assert _weight(pe).grad()._data is None


def test_kvstore_sparse_push_updates_lazily():
    """Row-sparse pushes to a store with an optimizer merge compactly
    into the lazy update (the reference's sparse push)."""
    from mxnet_tpu_torch import optimizer
    full = onp.ones((10, 2), "float32")
    kv = P.kv.create("device")
    kv.init(0, nd.array(full))
    kv.set_optimizer(optimizer.create("sgd", learning_rate=1.0))
    a = sparse.row_sparse_array((onp.ones((2, 2), "f"), [1, 3]),
                                shape=(10, 2))
    b = sparse.row_sparse_array((onp.ones((1, 2), "f"), [3]),
                                shape=(10, 2))
    kv.push(0, [a, b])
    out = nd.zeros((10, 2))
    kv.pull(0, out=out)
    want = full.copy()
    want[1] -= 1
    want[3] -= 2
    onp.testing.assert_array_equal(out.asnumpy(), want)
