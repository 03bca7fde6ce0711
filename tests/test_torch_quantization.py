"""The port's ``contrib.quantization`` against the JAX package's, on the
CPU, on the same seeded numpy inputs.

The weights quantize in numpy in both packages, so ``qweight`` and
``wscale`` must be equal bit for bit, and so must the entropy
thresholds.  The int8 products accumulate in int32 in both (exact), and
the float32 epilogue is the same sequence of operations, so layer
outputs are held at 1e-6 relative to their max-abs (reassociation in
XLA's fused epilogue is the only difference).  A quantized GPT-2's
logits at 1e-5 absolute (two layers of the same), its greedy streams
identical.  The port's ``int8_matmul`` pads on the CPU as on the card,
so the 4-row and K = 147 cases run the card's padding here.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu.contrib import quantization as RQ
from mxnet_tpu_torch.contrib import quantization as PQ
from mxnet_tpu_torch.utils.convert import load_numpy_params
from torch_ref_nets import gpt2_pair, seeded

REL = 1e-6


def _params(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


def _close(got, want, rel=REL):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = onp.abs(got.astype("f8") - want.astype("f8")).max()
    assert err <= rel * max(onp.abs(want).max(), 1e-6), err


def _pair(make_ref, make_port, seed=0, bias=True):
    """A reference layer initialized under ``seed`` (biases drawn off
    zero) and the port's CPU layer holding the same weights."""
    with seeded(seed):
        ref = make_ref(R)
        ref.initialize(R.init.Xavier())
        params = _params(ref)
        rs = onp.random.RandomState(seed + 1)
        for k in params:
            if bias and k.endswith("bias"):
                params[k] = rs.randn(*params[k].shape).astype("f")
                ref._collect_params_with_prefix()[k].set_data(
                    R.nd.array(params[k]))
    with P.cpu():
        port = load_numpy_params(make_port(P), params)
    return ref, port


def _run(ref, port, x):
    want = ref(R.nd.array(x)).asnumpy()
    with P.cpu():
        got = port(P.nd.array(x)).asnumpy()
    return got, want


OPS = {
    "quantize": lambda Q, nd, x: Q.quantize(nd.array(x), nd.array([-10.0]),
                                            nd.array([10.0])),
    "quantize_v2": lambda Q, nd, x: Q.quantize_v2(nd.array(x)),
    "quantize_v2_calibrated": lambda Q, nd, x: Q.quantize_v2(
        nd.array(x), min_calib_range=-1.5, max_calib_range=2.0),
    "quantize_v2_uint8": lambda Q, nd, x: Q.quantize_v2(
        nd.array(onp.abs(x)), out_type="uint8"),
    "dequantize": lambda Q, nd, x: (Q.dequantize(*Q.quantize_v2(
        nd.array(x))),),
    "dequantize_uint8": lambda Q, nd, x: (Q.dequantize(*Q.quantize_v2(
        nd.array(onp.abs(x)), out_type="uint8")),),
    "requantize": lambda Q, nd, x: Q.requantize(
        nd.array((x * (1 << 20)).astype("int64"), dtype="int32"),
        nd.array([-float(1 << 22)]), nd.array([float(1 << 22)]),
        min_calib_range=-(1 << 12), max_calib_range=1 << 12),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_equal_the_reference(name):
    """Every (data, min, max) triple equal to the reference's (the int8
    data bit for bit)."""
    x = onp.random.RandomState(0).randn(4, 8).astype("float32") * 3
    want = [a.asnumpy() for a in OPS[name](RQ, R.nd, x)]
    with P.cpu():
        got = [a.asnumpy() for a in OPS[name](PQ, P.nd, x)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.kind in "iu":
            assert onp.array_equal(g, w)
        else:
            _close(g, w)


@pytest.mark.parametrize("case", ["outlier", "bimodal"])
def test_entropy_threshold_equals_the_reference(case):
    rs = onp.random.RandomState(0)
    a = onp.abs(onp.concatenate([rs.randn(100000) * 0.5, [50.0]])) \
        if case == "outlier" else \
        onp.abs(onp.concatenate([rs.randn(5000), rs.randn(500) * 8]))
    hist, edges = onp.histogram(a, bins=2001, range=(0, a.max()))
    t = PQ.calib_entropy_threshold(hist, edges)
    assert t == RQ.calib_entropy_threshold(hist, edges)
    if case == "outlier":
        assert t < 10.0             # the lone outlier sets no range


@pytest.mark.parametrize("rows,shape", [(4, (64,)), (8, (64,)),
                                        (17, (64,)), (3, (4, 4, 4))])
def test_quantized_dense_equals_the_reference(rows, shape):
    """qweight and wscale bit for bit; the layer's outputs at 4 rows
    (padded to 32), 17 and a flattened 3-d input."""
    ref, port = _pair(lambda mx: mx.gluon.nn.Dense(
        24, in_units=64, activation="relu"),
        lambda mx: mx.gluon.nn.Dense(24, in_units=64, activation="relu"))
    rq, pq = RQ.QuantizedDense(ref), PQ.QuantizedDense(port)
    assert onp.array_equal(pq.qweight.numpy(), rq.qweight.data().asnumpy())
    assert onp.array_equal(pq.wscale.numpy(), rq.wscale.data().asnumpy())
    x = onp.random.RandomState(rows).randn(rows, *shape).astype("float32")
    got, want = _run(rq, pq, x)
    _close(got, want)


CONVS = {
    # (channels, kernel, strides, padding, dilation, groups, in, bias, hw)
    "padded": (8, 3, 1, 1, 1, 1, 4, True, 10),
    "grouped_strided": (8, 3, 2, 1, 1, 2, 4, False, 9),
    "stem_k147": (16, 7, 2, 3, 1, 1, 3, True, 20),
    "dilated": (6, 3, 1, 2, 2, 1, 5, False, 11),
    "depthwise": (6, 3, 1, 1, 1, 6, 6, True, 8),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_quantized_conv_equals_the_reference(case):
    """Per-channel qweight and wscale bit for bit; the outputs with the
    reference's strides, padding, dilation and groups (K = 147 pads to
    152)."""
    c, k, s, p, d, g, cin, bias, hw = CONVS[case]

    def make(mx):
        return mx.gluon.nn.Conv2D(c, k, strides=s, padding=p, dilation=d,
                                  groups=g, in_channels=cin, use_bias=bias,
                                  activation="relu")

    ref, port = _pair(make, make)
    rq, pq = RQ.QuantizedConv2D(ref), PQ.QuantizedConv2D(port)
    assert onp.array_equal(pq.qweight.numpy(), rq.qweight.data().asnumpy())
    assert onp.array_equal(pq.wscale.numpy(), rq.wscale.data().asnumpy())
    x = onp.random.RandomState(1).uniform(-1, 1, (2, cin, hw, hw)) \
        .astype("f")
    got, want = _run(rq, pq, x)
    _close(got, want)


def test_channels_last_conv_is_refused():
    with P.cpu():
        conv = P.gluon.nn.Conv2D(4, 3, in_channels=3, layout="NHWC")
        conv.initialize()
        with pytest.raises(P.MXNetError, match="NHWC"):
            PQ.QuantizedConv2D(conv)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_quantized_pooling_equals_the_reference(pool_type):
    x = onp.random.RandomState(2).uniform(-1, 1, (2, 3, 8, 8)).astype("f")
    want = RQ.quantized_pooling(*RQ.quantize_v2(R.nd.array(x)),
                                kernel=(2, 2), stride=(2, 2),
                                pool_type=pool_type)
    with P.cpu():
        got = PQ.quantized_pooling(*PQ.quantize_v2(P.nd.array(x)),
                                   kernel=(2, 2), stride=(2, 2),
                                   pool_type=pool_type)
        got = [a.asnumpy() for a in got]
    want = [a.asnumpy() for a in want]
    assert got[0].dtype == onp.int8 and onp.array_equal(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2], want[2])


def _mlp(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8), nn.Dense(4,
                                                                 in_units=16))
    return net


def _convnet(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3, activation="relu"),
            nn.MaxPool2D(), nn.Conv2D(4, 1, in_channels=8), nn.Flatten(),
            nn.Dense(5, in_units=64))
    return net


@pytest.mark.parametrize("mode,make", [
    ("none", _mlp), ("naive", _mlp), ("entropy", _mlp), ("naive", _convnet)],
    ids=["mlp-none", "mlp-naive", "mlp-entropy", "convnet-naive"])
def test_quantize_net_equals_the_reference(mode, make):
    """Every Dense and Conv2D swapped, each ``acts_range`` equal to the
    reference's (NaN for none, the KL thresholds for entropy), and the
    net's outputs."""
    ref, port = _pair(make, make, seed=3)
    rs = onp.random.RandomState(4)
    shape = (8,) if make is _mlp else (3, 8, 8)
    calib = [rs.randn(6, *shape).astype("f") for _ in range(2)]
    x = rs.randn(5, *shape).astype("f") * 1.5
    RQ.quantize_net(ref, calib_data=[R.nd.array(c) for c in calib],
                    calib_mode=mode)
    with P.cpu():
        PQ.quantize_net(port, calib_data=[P.nd.array(c) for c in calib],
                        calib_mode=mode)
    kinds = [type(c).__name__ for c in port]
    assert kinds == [type(c).__name__ for c in ref]
    assert not {"Dense", "Conv2D"} & set(kinds)
    for rc, pc in zip(ref, port):
        if hasattr(rc, "acts_range"):
            onp.testing.assert_array_equal(
                pc.acts_range.numpy(), rc.acts_range.data().asnumpy())
    got, want = _run(ref, port, x)
    _close(got, want)


def test_quantize_net_settles_deferred_shapes_and_excludes():
    """Deferred Dense layers settle on the first calibration batch;
    ``exclude_layers`` keeps a layer float; without calibration data a
    deferred layer raises; only int8 is accepted."""
    with P.cpu():
        net = P.gluon.nn.HybridSequential()
        net.add(P.gluon.nn.Dense(16, activation="relu"),
                P.gluon.nn.Dense(4))
        net.initialize()
        calib = [P.nd.array(onp.ones((8, 12), "f"))]
        PQ.quantize_net(net, calib_data=calib, exclude_layers=["1"])
        assert [type(c).__name__ for c in net] == ["QuantizedDense", "Dense"]
        assert net[0].qweight.shape == (16, 12)
        fresh = P.gluon.nn.HybridSequential()
        fresh.add(P.gluon.nn.Dense(4))
        fresh.initialize()
        with pytest.raises(P.MXNetError, match="deferred"):
            PQ.quantize_net(fresh, calib_mode="none")
        with pytest.raises(P.MXNetError, match="int8"):
            PQ.quantize_net(_mlp(P), quantized_dtype="uint8")


def test_reference_saved_quantized_net_loads_into_the_port(tmp_path):
    """A quantized net saved by the reference (int8 qweight, wscale, the
    calibrated range, biases) loads into the port's quantized net of the
    same structure and gives the reference's outputs; the port's file
    loads back into the reference."""
    ref, _ = _pair(_mlp, _mlp, seed=6)
    rs = onp.random.RandomState(7)
    calib = [R.nd.array(rs.randn(16, 8).astype("f")) for _ in range(2)]
    RQ.quantize_net(ref, calib_data=calib, calib_mode="naive")
    x = rs.randn(4, 8).astype("f") * 10     # beyond the calibrated range
    want = ref(R.nd.array(x)).asnumpy()
    f = str(tmp_path / "q.params")
    ref.save_parameters(f)
    with P.cpu():
        port = _mlp(P)
        port.initialize()
        PQ.quantize_net(port, calib_mode="none")
        port.load_parameters(f)
        assert port[0].qweight.dtype == torch.int8
        got = port(P.nd.array(x)).asnumpy()
        port.save_parameters(str(tmp_path / "p.params"))
    _close(got, want)
    back = _mlp(R)
    back.initialize()
    RQ.quantize_net(back, calib_mode="none")
    back.load_parameters(str(tmp_path / "p.params"))
    _close(back(R.nd.array(x)).asnumpy(), want)


def test_hybridized_quantized_net_follows_each_input():
    """A hybridized net without calibration replays its program with a
    range taken from each input: two inputs of one signature give their
    own eager results."""
    _, port = _pair(_mlp, _mlp, seed=8)
    rs = onp.random.RandomState(9)
    xs = [rs.randn(4, 8).astype("f"), rs.randn(4, 8).astype("f") * 20]
    with P.cpu():
        PQ.quantize_net(port, calib_mode="none")
        eager = [port(P.nd.array(x)).asnumpy() for x in xs]
        port.hybridize()
        for x, want in zip(xs, eager):
            assert onp.array_equal(port(P.nd.array(x)).asnumpy(), want)
        assert port._cached_op is not None


def test_quantized_gpt2_forward_and_greedy_stream_equal_the_reference():
    """A 2-layer, narrow GPT-2 quantized through ``optimize_for(backend=
    'INT8')`` in both packages with naive calibration: 12 QuantizedDense
    layers, logits within 1e-5, the greedy stream of 8 tokens (its
    4-row decode steps padded for ``_int_mm``) identical."""
    jn, tn = gpt2_pair(0, vocab_size=128, units=64, num_layers=2,
                       num_heads=4, max_length=48, dropout=0.0)
    rs = onp.random.RandomState(1)
    calib = rs.randint(0, 128, (2, 16)).astype("int32")
    x = rs.randint(0, 128, (4, 16)).astype("int32")
    jn.optimize_for(R.nd.array(calib, dtype="int32"), backend="INT8",
                    calib_data=[R.nd.array(calib, dtype="int32")],
                    calib_mode="naive")
    want = jn(R.nd.array(x, dtype="int32")).asnumpy()
    want_toks = onp.asarray(jn.generate(R.nd.array(x[:, :6], dtype="int32"),
                                        8, temperature=0.0))
    with P.cpu():
        tn.optimize_for(P.nd.array(calib, dtype="int32"), backend="INT8",
                        calib_data=[P.nd.array(calib, dtype="int32")],
                        calib_mode="naive")
        assert sum(isinstance(m, PQ.QuantizedDense)
                   for m in tn.modules()) == 12
        assert not any(type(m).__name__ == "Dense" for m in tn.modules())
        got = tn(P.nd.array(x, dtype="int32")).asnumpy()
        toks = tn.generate(x[:, :6], 8, temperature=0.0).numpy()
    onp.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert onp.array_equal(toks, want_toks)
