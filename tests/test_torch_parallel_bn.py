"""BatchNorm under data parallelism: the port's statistics are the
global batch's, as the reference's are.

A conv net (Conv 3->8, BatchNorm, ReLU, Dense 10; batches of 8 images
3x8x8, the second half of each shifted by +3, so the ranks' own
statistics differ from the batch's) takes 3 SGD steps on a dp = 2 mesh:
the port over two gloo ranks (``torch_dist_worker.py``, scenario
``bn``), the reference with its ``ShardedTrainer`` on two devices of its
CPU mesh, both from one set of seeded weights.  Losses, every parameter
and the moving statistics are held at ``test_torch_parallel.py``'s
tolerances (losses relative 1e-5, the rest max-abs 1e-4).  Without a
mesh, and under a mesh of one rank, BatchNorm's training call is the
one-device op bit for bit.
"""
import os

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ndarray import ops as tops

import torch_dist_worker as W

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4


def _weights():
    rs = onp.random.RandomState(7)
    net = W.bn_net(jnn)
    net.initialize(mx.init.Zero())
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        if k.endswith(("gamma", "running_var")):
            v = rs.uniform(0.5, 1.5, p.shape)
        elif len(p.shape) == 1:
            v = rs.uniform(-0.1, 0.1, p.shape)
        else:
            v = rs.randn(*p.shape) * onp.sqrt(2.0 / onp.prod(p.shape[1:]))
        out[k] = v.astype("float32")
    return out


def _ref_ce(logits, labels):
    from mxnet_tpu.ndarray import ops as F
    return (F.logsumexp(logits, axis=-1)
            - F.pick(logits, labels, axis=-1)).mean()


def _ref_run(params):
    net = W.bn_net(jnn)
    net.initialize(mx.init.Zero())
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    net.hybridize()
    mesh = jpar.make_mesh(dp=2, devices=jax.devices()[:2])
    with jpar.use_mesh(mesh):
        tr = jpar.ShardedTrainer(net, "sgd", loss=_ref_ce, mesh=mesh,
                                 optimizer_params={"learning_rate":
                                                   W.BN_LR})
        losses = [float(tr.step(mx.nd.array(x),
                                (mx.nd.array(y, dtype="int32"),))
                        .asnumpy()) for x, y in W.bn_batches()]
    return onp.array(losses), {k: onp.asarray(v.asnumpy())
                               for k, v in tr.state_dict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("bn")
    params = _weights()
    onp.savez(os.path.join(d, "params.npz"), **params)
    return params, W.launch(2, "bn", d)


@pytest.mark.parametrize("what", ["losses", "param", "aux"])
def test_bn_dp2_matches_the_reference_mesh(run, what):
    params, ranks = run
    losses, state = _ref_run(params)
    for r, out in enumerate(ranks):
        if what == "losses":
            onp.testing.assert_allclose(out["bn:losses"], losses,
                                        rtol=LOSS_RTOL, err_msg=f"rank {r}")
            continue
        keys = [k for k in state if k.startswith(what + ":")]
        assert keys, what
        if what == "aux":
            assert len(keys) == 2          # running_mean, running_var
        for k in keys:
            onp.testing.assert_allclose(out[f"bn:{k}"], state[k],
                                        rtol=0, atol=PARAM_TOL,
                                        err_msg=f"rank {r} {k}")


def _one_device_op_bit_for_bit():
    """The layer's training call and its moving statistics equal
    ``ops.batch_norm`` bit for bit."""
    x = torch.tensor(W.bn_batches(1)[0][0])
    with tmx.cpu():
        bn = tnn.BatchNorm(in_channels=3)
        bn.initialize()
    rm0, rv0 = bn.running_mean.detach().clone(), bn.running_var.detach()\
        .clone()
    with tmx.autograd.record():
        got = bn(x)
    want, mean, var = tops.batch_norm(x, bn.gamma, bn.beta, rm0, rv0,
                                      1e-5, False, True, 1)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, 0.9 * rm0 + 0.1 * mean)
    assert torch.equal(bn.running_var, 0.9 * rv0 + 0.1 * var)


def test_bn_without_a_mesh_is_the_one_device_op():
    """No mesh: the layer is the one-device op bit for bit."""
    _one_device_op_bit_for_bit()


def test_bn_under_a_one_rank_mesh_is_the_one_device_op(tmp_path):
    """A mesh whose dp x sp group is this rank alone (a one-process gloo
    job, whose mesh hands out the world group): the layer is the
    one-device op bit for bit."""
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel as tpar
    from mxnet_tpu_torch.gluon.nn.basic_layers import _data_group
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = tpar.make_mesh(dp=1)
        assert mesh.group(("dp", "sp")) is dist.group.WORLD
        with tpar.use_mesh(mesh):
            assert _data_group() is None
            _one_device_op_bit_for_bit()
    finally:
        dist.destroy_process_group()
