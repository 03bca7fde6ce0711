"""The port's ``gluon.rnn`` against the JAX package's, on one set of
weights.

Layers (``RNN`` relu and tanh, ``LSTM``, ``GRU``; one and two
directions; ``TNC`` and ``NTC``; two layers; given and default states)
and every cell (``RNNCell``, ``LSTMCell``, ``GRUCell``, ``LSTMPCell``,
the containers and modifiers, ``BidirectionalCell``, through ``unroll``)
are built in both packages; the port gets the reference's parameters by
``load_numpy_params`` (seeded values, biases included).  Compared:
outputs, last states and, under ``autograd.record()``, the gradients of
every parameter and of the input for a seeded head gradient.  The
cells' random masks (zoneout, variational dropout) are drawn by
different generators, so their training-mode behaviour is checked on
the port alone, as the reference's own tests check it.

Tolerance: rtol 1e-4, atol 1e-5 in float32.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.utils.convert import load_numpy_params

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
B, T, C, H = 3, 4, 6, 5


def _close(a, b, what):
    onp.testing.assert_allclose(onp.asarray(a, "float64"),
                                onp.asarray(b, "float64"), rtol=RTOL,
                                atol=ATOL, err_msg=what)


def _seed_params(jnet, seed=0):
    """Seeded values for every reference parameter (biases too);
    returns them by structural name."""
    rs = onp.random.RandomState(seed)
    out = {}
    for k, p in jnet._collect_params_with_prefix().items():
        v = rs.uniform(-0.4, 0.4, p.shape).astype("float32")
        p.set_data(mx.nd.array(v))
        out[k] = v
    return out


def _pair(make_j, make_t, x_shape):
    """The reference block (initialized, its shapes settled on one
    input) and the port's with the same weights."""
    jnet = make_j()
    jnet.initialize()
    jnet(mx.nd.zeros(x_shape))
    params = _seed_params(jnet)
    tnet = load_numpy_params(make_t(), params, device="cpu")
    return jnet, tnet, params


def _heads(shapes, seed=1):
    rs = onp.random.RandomState(seed)
    return [rs.uniform(0.5, 1.5, s).astype("float32") for s in shapes]


def _run(pkg, net, call, x_np, n_out):
    """Outputs of ``call(net, x)`` (a list) and the gradients of the
    input and of every parameter for ``sum(out_i * head_i)``, recorded
    in inference mode (no dropout draw: the packages' generators
    differ)."""
    x = pkg.nd.array(x_np)
    x.attach_grad()
    with pkg.autograd.record(train_mode=False):
        outs = call(net, x)
        heads = _heads([o.shape for o in outs])
        total = None
        for o, hg in zip(outs, heads):
            term = (o * pkg.nd.array(hg)).sum()
            total = term if total is None else total + term
    total.backward()
    params = (net._collect_params_with_prefix() if pkg is mx
              else net.collect_params())
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    assert len(outs) == n_out
    return [o.asnumpy() for o in outs], x.grad.asnumpy(), grads


def _compare(jnet, tnet, call, x_np, n_out):
    want = _run(mx, jnet, call, x_np, n_out)
    with tmx.cpu():
        got = _run(tmx, tnet, call, x_np, n_out)
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert a.shape == b.shape, i
        _close(a, b, f"output {i}")
    _close(got[1], want[1], "input gradient")
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], f"gradient {k}")


LAYERS = {"rnn_relu": (lambda m, **kw: m.RNN(H, activation="relu", **kw)),
          "rnn_tanh": (lambda m, **kw: m.RNN(H, activation="tanh", **kw)),
          "lstm": (lambda m, **kw: m.LSTM(H, **kw)),
          "gru": (lambda m, **kw: m.GRU(H, **kw))}


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", sorted(LAYERS))
def test_layer_matches_reference(mode, bidir, layout):
    kw = dict(num_layers=2, bidirectional=bidir, layout=layout,
              input_size=C)
    shape = (T, B, C) if layout == "TNC" else (B, T, C)
    jnet, tnet, _p = _pair(lambda: LAYERS[mode](jrnn, **kw),
                           lambda: LAYERS[mode](trnn, **kw), shape)
    x = onp.random.RandomState(3).randn(*shape).astype("float32")
    n_states = 2 if mode == "lstm" else 1
    st = [onp.random.RandomState(4 + i).randn(2 * (1 + bidir), B, H)
          .astype("float32") * 0.5 for i in range(n_states)]

    def with_states(net, xv):
        pkg = tmx if isinstance(xv, tmx.nd.NDArray) else mx
        out, states = net(xv, [pkg.nd.array(s) for s in st])
        return [out] + list(states)
    _compare(jnet, tnet, with_states, x, 1 + n_states)
    _compare(jnet, tnet, lambda net, xv: [net(xv)], x, 1)


def test_layer_names_begin_state_and_deferred_input():
    jl = jrnn.LSTM(H, num_layers=2, bidirectional=True)
    tl = trnn.LSTM(H, num_layers=2, bidirectional=True)
    names = list(tl.collect_params().keys())
    assert names == list(jl._collect_params_with_prefix().keys())
    assert names[:4] == ["l0_i2h_weight", "l0_h2h_weight", "l0_i2h_bias",
                         "l0_h2h_bias"] and "r1_h2h_bias" in names
    # deferred input size: the reference's values fill the 0, and the
    # first call agrees with the reference
    jl.initialize()
    x = onp.random.RandomState(0).randn(T, B, C).astype("float32")
    want = jl(mx.nd.array(x)).asnumpy()
    params = _seed_params(jl)
    want = jl(mx.nd.array(x)).asnumpy()
    load_numpy_params(tl, params, device="cpu")
    assert tuple(tl.l0_i2h_weight.shape) == (4 * H, C)
    with tmx.cpu():
        got = tl(tmx.nd.array(x)).asnumpy()
        states = tl.begin_state(B)
    _close(got, want, "deferred LSTM")
    assert [tuple(s.shape) for s in states] == [(4, B, H)] * 2
    # an uninitialized deferred layer settles at its first call
    g = trnn.GRU(H, layout="NTC").initialize(seed=0, device="cpu")
    assert tuple(g(torch.zeros(B, T, C)).shape) == (B, T, H)
    assert tuple(g.l0_i2h_weight.shape) == (3 * H, C)


def _cells(m):
    return {
        "rnn_relu": lambda: m.RNNCell(H, activation="relu", input_size=C),
        "rnn_tanh": lambda: m.RNNCell(H, input_size=C),
        "lstm": lambda: m.LSTMCell(H, input_size=C),
        "gru": lambda: m.GRUCell(H, input_size=C),
        "lstmp": lambda: m.LSTMPCell(H, 3, input_size=C),
        "sequential": lambda: _seq(m),
        "residual": lambda: m.ResidualCell(m.GRUCell(C, input_size=C)),
        "dropout_cells": lambda: _mods(m),
    }


def _seq(m):
    s = m.SequentialRNNCell()
    s.add(m.LSTMCell(H, input_size=C))
    s.add(m.GRUCell(H, input_size=H))
    return s


def _mods(m):
    """The dropout-style modifiers in inference mode: each passes its
    base cell through."""
    s = m.SequentialRNNCell()
    s.add(m.ZoneoutCell(m.LSTMCell(H, input_size=C), 0.3, 0.3))
    s.add(m.DropoutCell(0.5))
    s.add(m.VariationalDropoutCell(m.RNNCell(H, input_size=H), 0.3, 0.3,
                                   0.3))
    return s


@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", False)])
@pytest.mark.parametrize("kind", sorted(_cells(trnn)))
def test_cell_unroll_matches_reference(kind, layout, merge):
    shape = (B, T, C) if layout == "NTC" else (T, B, C)
    jc, tc = _cells(jrnn)[kind](), _cells(trnn)[kind]()
    jc.initialize()
    params = _seed_params(jc)
    load_numpy_params(tc, params, device="cpu")
    x = onp.random.RandomState(5).randn(*shape).astype("float32")

    def call(cell, xv):
        outs, states = cell.unroll(T, xv, layout=layout,
                                   merge_outputs=merge)
        return (([outs] if merge else list(outs)) + list(states))
    n_st = len(tc.state_info())
    _compare(jc, tc, call, x, (1 if merge else T) + n_st)


def test_bidirectional_cell_matches_reference():
    def make(m):
        return m.BidirectionalCell(m.LSTMCell(H, input_size=C),
                                   m.GRUCell(H, input_size=C))
    jc, tc = make(jrnn), make(trnn)
    jc.initialize()
    load_numpy_params(tc, _seed_params(jc), device="cpu")
    x = onp.random.RandomState(6).randn(B, T, C).astype("float32")
    st = [onp.random.RandomState(7 + i).randn(B, H).astype("float32")
          for i in range(3)]

    def call(cell, xv):
        pkg = tmx if isinstance(xv, tmx.nd.NDArray) else mx
        outs, states = cell.unroll(T, xv, [pkg.nd.array(s) for s in st],
                                   layout="NTC", merge_outputs=True)
        return [outs] + list(states)
    _compare(jc, tc, call, x, 4)


def test_one_step_with_begin_state_matches_reference():
    jc, tc = jrnn.LSTMCell(H, input_size=C), trnn.LSTMCell(H, input_size=C)
    jc.initialize()
    load_numpy_params(tc, _seed_params(jc), device="cpu")
    x = onp.random.RandomState(8).randn(B, C).astype("float32")
    jo, js = jc(mx.nd.array(x), jc.begin_state(B))
    with tmx.cpu():
        to, ts = tc(tmx.nd.array(x), tc.begin_state(B))
    _close(to.asnumpy(), jo.asnumpy(), "LSTMCell output")
    for a, b in zip(ts, js):
        _close(a.asnumpy(), b.asnumpy(), "LSTMCell state")


def test_dropout_cells_in_training():
    """Variational dropout keeps one mask per sequence until reset;
    zoneout keeps some previous values; dropout drops; a reset between
    unrolls lets the batch size change; inference draws nothing."""
    with tmx.cpu():
        v = trnn.VariationalDropoutCell(trnn.RNNCell(8, input_size=8),
                                        drop_outputs=0.5)
        v.initialize(seed=0)
        x = tmx.nd.ones((2, 8))
        st = v.begin_state(2)
        with tmx.base.training_mode(True):
            o1, st2 = v(x, st)
            o2, _ = v(x, st2)
            z1, z2 = o1.asnumpy() == 0, o2.asnumpy() == 0
            assert z1.any()
            onp.testing.assert_array_equal(z1, z2)
            s = trnn.SequentialRNNCell()
            s.add(v)
            s.unroll(3, tmx.nd.ones((4, 3, 8)), merge_outputs=True)
            s.unroll(3, tmx.nd.ones((2, 3, 8)), merge_outputs=True)
            z = trnn.ZoneoutCell(trnn.RNNCell(8, input_size=8), 0.5, 0.5)
            z.initialize(seed=0)
            outs, _ = z.unroll(4, tmx.nd.ones((3, 4, 8)) * 0.5,
                               merge_outputs=True)
            o = outs.asnumpy()
            assert (o[:, 1:] == o[:, :-1]).any()
            d, _ = trnn.DropoutCell(0.5)(tmx.nd.ones((4, 8)), [])
            assert (d.asnumpy() == 0).any() and (d.asnumpy() == 2).any()
        v.reset()
        assert v._mask_o is None
        o3, _ = v(x, st)
        assert not (o3.asnumpy() == 0).all()
    assert trnn.HybridSequentialRNNCell is trnn.SequentialRNNCell
    assert isinstance(trnn.ZoneoutCell(trnn.LSTMCell(4)), trnn.ModifierCell)
