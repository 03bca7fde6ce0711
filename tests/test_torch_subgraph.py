"""The port's subgraph API (``mxnet_tpu_torch.subgraph``,
``HybridBlock.optimize_for``) against the JAX package's, on the CPU.

Mirrors ``tests/test_subgraph.py``: ``FUSE_BN`` folds each BatchNorm into
the Conv2D or Dense before it and the fused net's outputs equal the
reference's fused net's from the same parameters and running
statistics (copied across with ``save_parameters`` /
``load_parameters``); the ``optimize_for`` block API; a custom backend;
a rewrite that drops a hybridized net's cached program; and ``INT8``
(``contrib.quantization.quantize_net``) against the reference's.
Tolerance: the reference's 1e-4 relative, 1e-5 absolute.
"""
import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu_torch.subgraph import (SubgraphProperty, list_backends,
                                      optimize_for, register_backend)

RTOL, ATOL = 1e-4, 1e-5


def _conv_bn_net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), nn.Conv2D(4, 1, use_bias=True),
            nn.BatchNorm(), nn.Flatten(), nn.Dense(3))
    return net


def _dense_bn_net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16), nn.BatchNorm(), nn.Activation("relu"),
            nn.Dense(4))
    return net


def _pair(build, x, tmp_path):
    """The reference net with random running statistics, and the port's
    net loaded from its params."""
    rs = onp.random.RandomState(9)
    rnet = build(R)
    R.random.seed(0)
    rnet.initialize()
    rnet(R.nd.array(x))
    for name, p in rnet.collect_params().items():
        if name.endswith(("running_mean", "beta")):
            p.set_data(R.nd.array(rs.uniform(-1, 1, p.shape).astype("f")))
        elif name.endswith(("running_var", "gamma")):
            p.set_data(R.nd.array(rs.uniform(0.5, 2, p.shape).astype("f")))
    f = str(tmp_path / "net.params")
    rnet.save_parameters(f)
    with P.cpu():
        pnet = build(P)
        pnet.load_parameters(f, ctx=P.cpu())
    return rnet, pnet


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_fuse_bn_matches_the_reference(kind, tmp_path):
    build = _conv_bn_net if kind == "conv" else _dense_bn_net
    shape = (4, 3, 8, 8) if kind == "conv" else (6, 10)
    x = onp.random.RandomState(0).uniform(-1, 1, shape).astype("f")
    rnet, pnet = _pair(build, x, tmp_path)
    r_before = rnet(R.nd.array(x)).asnumpy()
    R.subgraph.optimize_for(rnet, "FUSE_BN")
    r_after = rnet(R.nd.array(x)).asnumpy()
    with P.cpu():
        p_before = pnet(P.nd.array(x)).asnumpy()
        assert optimize_for(pnet, "fuse_bn") is pnet      # case-insensitive
        p_after = pnet(P.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(p_before, r_before, rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(p_after, r_after, rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(p_after, p_before, rtol=RTOL, atol=ATOL)
    kinds = [type(c).__name__ for c in pnet.children()]
    assert kinds == [type(c).__name__ for c in rnet._children.values()]
    assert "BatchNorm" not in kinds
    assert pnet[0].bias is not None                # grown by the fold
    names = sorted(pnet.collect_params())
    assert names == sorted(rnet._collect_params_with_prefix())


def test_optimize_for_block_api(tmp_path):
    """``net.optimize_for(x, backend=...)`` rewrites, hybridizes and runs
    one forward."""
    x = onp.random.RandomState(1).uniform(-1, 1, (2, 3, 8, 8)).astype("f")
    rnet, pnet = _pair(_conv_bn_net, x, tmp_path)
    want = rnet.optimize_for(R.nd.array(x), backend="FUSE_BN").asnumpy()
    with P.cpu():
        ref = pnet(P.nd.array(x)).asnumpy()
        out = pnet.optimize_for(P.nd.array(x), backend="FUSE_BN")
        again = pnet(P.nd.array(x)).asnumpy()
    assert pnet._active
    onp.testing.assert_allclose(out.asnumpy(), ref, rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(out.asnumpy(), want, rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(again, out.asnumpy(), rtol=0, atol=0)


def test_rewrite_invalidates_the_cached_program(tmp_path):
    """A rewrite of an already-hybridized net drops every CachedOp of the
    tree, so the next call runs the rewritten net."""
    x = onp.random.RandomState(4).uniform(-1, 1, (2, 3, 8, 8)).astype("f")
    _rnet, pnet = _pair(_conv_bn_net, x, tmp_path)
    with P.cpu():
        pnet.hybridize()
        ref = pnet(P.nd.array(x)).asnumpy()
        assert pnet._cached_op is not None
        optimize_for(pnet, "FUSE_BN")
        assert pnet._cached_op is None
        out = pnet(P.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_builtin_and_custom_backends():
    """FUSE_BN and INT8 are registered; an unknown backend raises; a
    registered property receives the keyword arguments."""
    assert {"FUSE_BN", "INT8"} <= set(list_backends())
    with P.cpu():
        net = _conv_bn_net(P)
        net.initialize()
    with pytest.raises(P.MXNetError):
        optimize_for(net, "NO_SUCH_BACKEND")
    calls = []

    class Tag(SubgraphProperty):
        name = "PORT_TAGGER"

        def apply_block(self, net, **kw):
            calls.append(kw)
            return net

    register_backend(Tag())
    assert "PORT_TAGGER" in list_backends()
    assert optimize_for(net, "port_tagger", level=3) is net
    assert calls == [{"level": 3}]
    with pytest.raises(P.MXNetError):
        P.sym.Variable("data").optimize_for("FUSE_BN")


def test_int8_backend_matches_the_reference(tmp_path):
    """INT8 through ``optimize_for`` with naive calibration swaps every
    Conv2D and Dense for its int8 layer, as the reference's does, with
    the reference's calibrated ranges and outputs (the int8 products are
    exact; the float32 epilogue at the file's tolerance)."""
    rs = onp.random.RandomState(5)
    x = rs.uniform(-1, 1, (2, 3, 8, 8)).astype("f")
    calib = [rs.uniform(-1, 1, (4, 3, 8, 8)).astype("f") for _ in range(2)]
    rnet, pnet = _pair(_conv_bn_net, x, tmp_path)
    want = rnet.optimize_for(R.nd.array(x), backend="INT8",
                             calib_data=[R.nd.array(c) for c in calib],
                             calib_mode="naive").asnumpy()
    with P.cpu():
        got = pnet.optimize_for(P.nd.array(x), backend="INT8",
                                calib_data=[P.nd.array(c) for c in calib],
                                calib_mode="naive").asnumpy()
        again = pnet(P.nd.array(x)).asnumpy()
    kinds = [type(c).__name__ for c in pnet.children()]
    assert kinds == [type(c).__name__ for c in rnet._children.values()]
    assert kinds.count("QuantizedConv2D") == 2 and "Dense" not in kinds
    for pc, rc in zip(pnet.children(), rnet._children.values()):
        if hasattr(rc, "acts_range"):
            onp.testing.assert_array_equal(pc.acts_range.numpy(),
                                           rc.acts_range.data().asnumpy())
    assert pnet._active
    onp.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    onp.testing.assert_array_equal(again, got)
