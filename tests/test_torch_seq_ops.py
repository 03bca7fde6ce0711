"""The port's sequence and RNN ops against the JAX package's.

``SequenceMask``, ``SequenceLast``, ``SequenceReverse`` (with lengths,
time-major and batch-major), the interleaved self-attention products
and the fused ``RNN`` over MXNet's flat parameter vector (every mode,
one and two directions, two layers, states out) take the same seeded
numpy inputs in both packages; values and input gradients (for a
seeded head gradient) are compared.  The port's two RNN routes (torch's
fused recurrent op, which is cuDNN on the card, and the step-by-step
decomposition) are held together on the CPU, dropout between layers
included.

Tolerance: rtol 1e-4, atol 1e-5 in float32 (one function, summed in
another order).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.rnn import _rnn_impl

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _close(a, b, what):
    onp.testing.assert_allclose(onp.asarray(a, "float64"),
                                onp.asarray(b, "float64"), rtol=RTOL,
                                atol=ATOL, err_msg=what)


def _run(pkg, call, inputs, ints=()):
    """Outputs of ``call(nd, *arrays)`` and the float inputs' gradients
    for ``sum(out_i * head_i)`` over every output, seeded heads."""
    xs = [pkg.nd.array(a, dtype="int32" if i in ints else None)
          for i, a in enumerate(inputs)]
    for i, x in enumerate(xs):
        if i not in ints:
            x.attach_grad()
    with pkg.autograd.record():
        out = call(pkg.nd, *xs)
        outs = out if isinstance(out, list) else [out]
        rs = onp.random.RandomState(1)
        total = None
        for o in outs:
            hg = pkg.nd.array(rs.uniform(0.5, 1.5, o.shape)
                              .astype("float32"))
            term = (o * hg).sum()
            total = term if total is None else total + term
    total.backward()
    return ([o.asnumpy() for o in outs],
            [x.grad.asnumpy() for i, x in enumerate(xs) if i not in ints])


def _both(call, inputs, ints=()):
    want = _run(mx, call, inputs, ints)
    with tmx.cpu():
        got = _run(tmx, call, inputs, ints)
    for kind, w, g in (("value", want[0], got[0]), ("grad", want[1], got[1])):
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(g, w)):
            assert a.shape == b.shape, (kind, i)
            _close(a, b, f"{kind} {i}")


_rs = onp.random.RandomState(0)
X = _rs.randn(5, 3, 4).astype("float32")          # (T, B, C)
LENS = onp.array([2, 5, 3], "int32")


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_mask(axis):
    x = X if axis == 0 else X.transpose(1, 0, 2)
    _both(lambda F, d, n: F.SequenceMask(d, n, use_sequence_length=True,
                                         value=-2.5, axis=axis),
          [x, LENS], ints=(1,))


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_last(axis):
    x = X if axis == 0 else X.transpose(1, 0, 2)
    _both(lambda F, d, n: F.SequenceLast(d, n, use_sequence_length=True,
                                         axis=axis), [x, LENS], ints=(1,))
    _both(lambda F, d: F.SequenceLast(d, axis=axis), [x])


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_reverse(axis):
    x = X if axis == 0 else X.transpose(1, 0, 2)
    _both(lambda F, d, n: F.SequenceReverse(d, n, use_sequence_length=True,
                                            axis=axis), [x, LENS],
          ints=(1,))
    _both(lambda F, d: F.SequenceMask(d), [x])


def test_interleaved_selfatt_products():
    t, b, h, d = 5, 2, 3, 4
    qkv = _rs.randn(t, b, 3 * h * d).astype("float32")
    att = _rs.uniform(0, 1, (b * h, t, t)).astype("float32")
    _both(lambda F, x: F.interleaved_matmul_selfatt_qk(x, heads=h), [qkv])
    _both(lambda F, x, a: F.interleaved_matmul_selfatt_valatt(x, a,
                                                               heads=h),
          [qkv, att])


def _rnn_inputs(mode, bidir, layers=2, c=6, hid=5, b=3, t=4, seed=2):
    rs = onp.random.RandomState(seed)
    nd_ = 2 if bidir else 1
    gh = GATES[mode] * hid
    n = 0
    for li in range(layers):
        n += nd_ * (gh * (c if li == 0 else hid * nd_) + gh * hid + 2 * gh)
    ins = [rs.randn(t, b, c).astype("float32"),
           rs.uniform(-0.4, 0.4, n).astype("float32"),
           rs.randn(layers * nd_, b, hid).astype("float32") * 0.5]
    if mode == "lstm":
        ins.append(rs.randn(layers * nd_, b, hid).astype("float32") * 0.5)
    return ins


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", sorted(GATES))
def test_rnn_op_matches_reference(mode, bidir):
    ins = _rnn_inputs(mode, bidir)

    def call(F, x, flat, h0, *c0):
        return F.RNN(x, flat, h0, c0[0] if c0 else None, state_size=5,
                     num_layers=2, mode=mode, bidirectional=bidir,
                     state_outputs=True)
    _both(call, ins)


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", sorted(GATES))
def test_rnn_fused_route_matches_step_route(mode, bidir):
    """torch's fused recurrent op (cuDNN on the card) over the unpacked
    MXNet layout against the step-by-step decomposition, values and
    gradients, with dropout between the layers drawn from one seed."""
    ins = [torch.from_numpy(a) for a in _rnn_inputs(mode, bidir, layers=3)]
    res = {}
    for impl in ("fused", "step"):
        xs = [a.clone().requires_grad_() for a in ins]
        tmx.random.seed(7)
        with tmx.base.training_mode(True):
            outs = _rnn_impl.rnn_layer_forward(
                xs[0], _rnn_impl.unpack_params(
                    xs[1], 6, 5, 3, 2 if bidir else 1, mode),
                xs[2], xs[3] if mode == "lstm" else None, mode,
                p_dropout=0.3, impl=impl)
        outs = [o for o in outs if o is not None]
        total = sum((o * (i + 1.5)).sum() for i, o in enumerate(outs))
        res[impl] = ([o.detach() for o in outs],
                     torch.autograd.grad(total, xs))
    for a, b in zip(res["fused"][0] + list(res["fused"][1]),
                    res["step"][0] + list(res["step"][1])):
        _close(a.numpy(), b.numpy(), f"{mode} bidir={bidir}")


def test_rnn_op_without_state_outputs_and_bad_mode():
    ins = _rnn_inputs("gru", False, layers=1)
    with tmx.cpu():
        out = tmx.nd.RNN(*(tmx.nd.array(a) for a in ins), state_size=5,
                         num_layers=1, mode="gru", state_outputs=False)
        assert out.shape == (4, 3, 5)
        with pytest.raises(tmx.MXNetError):
            tmx.nd.RNN(*(tmx.nd.array(a) for a in ins), state_size=5,
                       num_layers=1, mode="elman")
        with pytest.raises(tmx.MXNetError):     # a vector of another size
            tmx.nd.RNN(tmx.nd.array(ins[0]), tmx.nd.array(ins[1][:-1]),
                       tmx.nd.array(ins[2]), state_size=5, num_layers=1,
                       mode="gru")
