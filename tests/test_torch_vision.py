"""The port's vision model zoo against the JAX package's.

Each family is built in both packages; after one forward the port's
deferred shapes give the reference's structural parameter names and
shapes.  Seeded numpy weights go into both (the reference's
``set_data``, the port's ``load_numpy_params``) and the same seeded
numpy images through both: logits in training mode (batch statistics;
the families without dropout) and then in predict mode (the moving
statistics that call moved; every family, dropout off).  Batch 2, 10
classes, at the smallest input each family accepts, but 64x64 for the
ResNets and MobileNets trained here: at 32x32 their last BatchNorm sees
2 values a channel, where float32 rounding grows to ~2e-3 in the logits
(the port's own float32 against its float64).  DenseNet runs narrow
(growth 8, one layer a block).

The reference is kept cheap: its deferred shapes settle abstractly
(``jax.eval_shape``, as its ``ShardedTrainer`` settles them) under a
constant initializer, and it runs hybridized (one compiled program),
since its random initializers and eager ops compile once per shape
(~55 s for Inception v3 here, against ~11 s this way).

A narrow ResNet v1 (``BottleneckV1``, 16-256 channels, NHWC, 64x64,
batch 4; at 32x32 its last BatchNorm sees 4 values a channel and the
port's own float32 and float64 steps part by 1e-4, at 64x64 by 2e-6)
then takes SGD-with-momentum steps from one set of weights through the
reference's ``ShardedTrainer`` and the port's, and through both
packages' Gluon loops: losses, every parameter, the BatchNorm moving
statistics and the momentum state agree.

Tolerances: logits max-abs error within 1e-4 of their max-abs (float32
convolutions summed in another order by XLA and torch, through up to 50
layers; in predict mode after one training call the moving statistics
do not yet match the activations, and ResNet-50 v2's logits reach
~1.5e3, where the port's own float32 and float64 part by 7e-3); losses
within rtol 1e-4; parameters, moving statistics and momentum within
1e-5 after SGD at lr 0.1.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as par
from mxnet_tpu.models import vision as jvision
from mxnet_tpu.ndarray import NDArray
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import vision as tvision
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.utils.convert import load_numpy_params, load_numpy_state

ATOL = 1e-4
LOGITS_TOL = 1e-4
STATE_TOL = 1e-5
B = 2

# one intra-op thread per test process (six xdist workers share eight
# cores in the tier-1 run)
torch.set_num_threads(1)


def _close(a, b, what, tol=ATOL):
    a, b = onp.asarray(a), onp.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    onp.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _images(size, layout="NCHW", seed=0, batch=B):
    x = onp.random.RandomState(seed).uniform(
        -1, 1, (batch, 3, size, size)).astype("float32")
    return onp.ascontiguousarray(x.transpose(0, 2, 3, 1)) \
        if layout == "NHWC" else x


def _ref_params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _weights(shapes, seed=0):
    """Seeded values for {name: shape}: BatchNorm scales and moving
    variances in [0.5, 1.5), shifts, biases and moving means in
    [-0.1, 0.1), weights He-scaled normals."""
    rs = onp.random.RandomState(seed)
    out = {}
    for k, shape in shapes.items():
        if k.endswith(("gamma", "running_var")):
            v = rs.uniform(0.5, 1.5, shape)
        elif len(shape) == 1:
            v = rs.uniform(-0.1, 0.1, shape)
        else:
            v = rs.randn(*shape) * onp.sqrt(2.0 / onp.prod(shape[1:]))
        out[k] = v.astype("float32")
    return out


def _ref_net(build, x, params=None):
    """The reference's ``build(vision)`` with shapes settled on ``x`` by
    abstract evaluation, its parameters set to ``params`` (default:
    :func:`_weights` of its shapes), hybridized."""
    net = build(jvision)
    net.initialize(mx.init.Zero())

    def settle(v):
        with mx.autograd.predict_mode():
            net(NDArray(v))
        return jnp.zeros(())
    jax.eval_shape(settle, x)
    handles = net._collect_params_with_prefix()
    if params is None:
        params = _weights({k: p.shape for k, p in handles.items()})
    for k, p in handles.items():
        p.set_data(mx.nd.array(params[k]))
    net.hybridize()
    return net


def test_zoo_names_equal_the_reference():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34
    assert tmx.gluon.model_zoo.vision.get_model is tvision.get_model
    assert tmx.models.get_model is tvision.get_model
    with pytest.raises(ValueError):
        tvision.get_model("resnet19_v1")


FAMILIES = {
    # name: (constructor(vision), input size, layout, dropout in the net)
    "resnet18_v1": (lambda v: v.resnet18_v1(classes=10), 64, "NCHW", False),
    "resnet18_v1 NHWC": (lambda v: v.resnet18_v1(classes=10, layout="NHWC"),
                         64, "NHWC", False),
    "resnet50_v2": (lambda v: v.resnet50_v2(classes=10), 64, "NCHW", False),
    "resnet50_v2 NHWC": (lambda v: v.resnet50_v2(classes=10, layout="NHWC"),
                         64, "NHWC", False),
    "resnet v2 basic thumbnail": (lambda v: v.ResNetV2(
        v.BasicBlockV2, [1, 1, 1, 1], [8, 8, 16, 32, 64], classes=10,
        thumbnail=True), 16, "NCHW", False),
    "mobilenet0_25": (lambda v: v.mobilenet0_25(classes=10), 64, "NCHW",
                      False),
    "mobilenet_v2_0_25": (lambda v: v.mobilenet_v2_0_25(classes=10), 64,
                          "NCHW", False),
    "densenet narrow": (lambda v: v.DenseNet(16, 8, [1, 1, 1, 1],
                                             classes=10), 32, "NCHW", False),
    "squeezenet1_1": (lambda v: v.squeezenet1_1(classes=10), 32, "NCHW",
                      True),
    "inception_v3": (lambda v: v.inception_v3(classes=10), 75, "NCHW",
                     True),
    "vgg11_bn": (lambda v: v.vgg11_bn(classes=10), 32, "NCHW", True),
    "alexnet": (lambda v: v.alexnet(classes=10), 63, "NCHW", True),
    "mlp": (lambda v: v.MLP(hidden=(32, 16)), 8, "NCHW", False),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_matches_reference(name):
    build, size, layout, dropout = FAMILIES[name]
    x = _images(size, layout)
    modes = ["predict"] if dropout else ["train", "predict"]

    def run(pkg, net):
        # a training call first, so the predict call reads the moving
        # statistics it moved
        outs = {}
        for mode in modes:
            with getattr(pkg.autograd, f"{mode}_mode")():
                outs[mode] = net(pkg.nd.array(x)).asnumpy()
        return outs

    ref = _ref_net(build, x)
    params = _ref_params(ref)
    want = run(mx, ref)
    with tmx.cpu():
        own = build(tvision)
        own.initialize(tmx.init.Xavier())
        with tmx.autograd.predict_mode():
            own(tmx.nd.array(x))
        assert {k: tuple(p.shape) for k, p in own.named_parameters()} == \
            {k: v.shape for k, v in params.items()}
        got = run(tmx, load_numpy_params(build(tvision), params))
    for mode in modes:
        err = onp.abs(got[mode] - want[mode]).max()
        assert err <= LOGITS_TOL * onp.abs(want[mode]).max(), (mode, err)


# ------------------------------------------------- a narrow ResNet step

NARROW = dict(classes=10, layout="NHWC")
NB, NSIZE, LR, MOMENTUM = 4, 64, 0.1, 0.9


def _narrow(vision):
    return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                           [16, 32, 64, 128, 256], **NARROW)


def _batch(seed):
    rs = onp.random.RandomState(seed)
    return (_images(NSIZE, "NHWC", seed, NB),
            rs.randint(0, 10, (NB,)).astype("int32"))


def _ref_ce(logits, labels):
    from mxnet_tpu.ndarray import ops as F
    return (F.logsumexp(logits, axis=-1)
            - F.pick(logits, labels, axis=-1)).mean()


def _port_ce(logits, labels):
    return torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.long()[:, None])[:, 0]


@pytest.fixture(scope="module")
def narrow_params():
    with tmx.cpu():
        net = _narrow(tvision)
        net.initialize()
        with tmx.autograd.predict_mode():
            net(tmx.nd.array(_batch(0)[0]))
    return _weights({k: tuple(p.shape) for k, p in net.named_parameters()})


def _ref_narrow(params):
    return _ref_net(_narrow, _batch(0)[0], params)


def _states_close(port_state, ref_state, what):
    assert set(port_state) == set(ref_state), what
    for k, v in ref_state.items():
        _close(port_state[k].numpy(), onp.asarray(v.asnumpy()),
               f"{what} {k}", tol=STATE_TOL)


def test_narrow_resnet_sharded_trainer_matches_reference(narrow_params):
    """Two SGD-with-momentum steps: losses, and the whole trainer state
    (every parameter, the moving statistics as ``aux:i`` in the
    reference's order, the momentum as ``state:i``) after them; the
    port's trainer then resumes from the reference's state dict."""
    mesh = par.make_mesh(dp=1, devices=jax.devices()[:1])
    ref = _ref_narrow(narrow_params)
    opt = {"learning_rate": LR, "momentum": MOMENTUM}
    with par.use_mesh(mesh):
        rtr = par.ShardedTrainer(ref, "sgd", loss=_ref_ce,
                                 optimizer_params=opt, mesh=mesh)
    with tmx.cpu():
        port = _narrow(tvision)
        port.initialize()
    load_numpy_params(port, narrow_params)
    ptr = ShardedTrainer(port, "sgd", loss=_port_ce, optimizer_params=opt)
    for seed in (1, 2):
        x, y = _batch(seed)
        with par.use_mesh(mesh):
            want = float(rtr.step(mx.nd.array(x),
                                  (mx.nd.array(y, dtype="int32"),))
                         .asnumpy())
        got = float(ptr.step(x, (y,)))
        _close(got, want, f"loss {seed}")
    ref_state = rtr.state_dict()
    # 17 BatchNorms (the stem's, 3 a block, 1 a projection shortcut)
    assert sum(k.startswith("aux:") for k in ref_state) == 17 * 2
    _states_close(ptr.state_dict(), ref_state, "after 2 steps")
    # resume: a fresh port trainer loads the reference's state
    with tmx.cpu():
        fresh = _narrow(tvision)
        fresh.initialize()
    load_numpy_params(fresh, narrow_params)
    ftr = ShardedTrainer(fresh, "sgd", loss=_port_ce, optimizer_params=opt)
    ftr.build(_batch(0)[0])
    load_numpy_state(ftr, ref_state)
    _states_close(ftr.state_dict(), ref_state, "resumed")


def test_narrow_resnet_gluon_loop_matches_reference(narrow_params):
    """The same step through ``record`` → ``SoftmaxCrossEntropyLoss`` →
    ``backward`` → ``gluon.Trainer.step`` in both packages."""
    ref = _ref_narrow(narrow_params)
    opt = {"learning_rate": LR, "momentum": MOMENTUM}
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", opt)
    rloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.cpu():
        port = _narrow(tvision)
        port.initialize()
        load_numpy_params(port, narrow_params)
        ptr = tmx.gluon.Trainer(port.collect_params(), "sgd", opt)
        ploss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        for seed in (1, 2):
            x, y = _batch(seed)
            with mx.autograd.record():
                lw = rloss(ref(mx.nd.array(x)), mx.nd.array(y))
            lw.backward()
            rtr.step(NB)
            with tmx.autograd.record():
                lg = ploss(port(tmx.nd.array(x)), tmx.nd.array(y))
            lg.backward()
            ptr.step(NB)
            _close(lg.asnumpy(), lw.asnumpy(), f"losses {seed}")
        want = _ref_params(ref)
        for k, p in port.named_parameters():
            _close(p.detach().numpy(), want[k], k, tol=STATE_TOL)
