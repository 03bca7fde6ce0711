"""The port's Gluon core against the JAX package's: blocks, containers,
deferred shapes, hybridize, parameters, layers, initializers and
``gluon.utils``.

Each case of the reference's ``tests/test_gluon.py`` that needs no
convolution runs here on both packages: the reference draws the
weights, the port takes them (``load_numpy_params`` or a parameter
file), and the same numpy inputs go through both.  Outputs and
gradients agree within 1e-5 (float32 sums taken in another order);
the reference's canonical program (MXNet's Gluon MNIST MLP) agrees
within 1e-5 in losses, step-1 gradients and parameters after 3 steps.
Deterministic initializers agree bit for bit; random ones are
held to their bounds, moments and orthogonality, since torch draws
other numbers than jax for the same seed.
"""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon, nd
from mxnet_tpu.gluon import nn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.utils.convert import load_numpy_params

TOL = 1e-5

# one intra-op thread per test process: the tier-1 run puts six xdist
# workers on eight cores, and torch's default (a thread per core in
# every worker) starves timing-sensitive tests running beside these
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _close(a, b, tol=TOL):
    onp.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _mlp(pkg, act="relu"):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(32, activation=act), pkg.gluon.nn.Dense(10))
    return net


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _ref_mlp(x, act="relu", seed=7):
    """The reference MLP, Xavier-initialized and materialized on ``x``."""
    mx.random.seed(seed)
    net = _mlp(mx, act)
    net.initialize(mx.init.Xavier())
    net(nd.array(x))
    return net


# ------------------------------------------------- tests/test_gluon.py cases

def test_dense_shapes_and_deferred_init():
    x = _rand(0, 4, 7)
    ref = nn.Dense(16)
    ref.initialize()
    want = ref(nd.array(x))
    net = tnn.Dense(16)
    net.initialize()
    assert net.weight.shape == (16, 0)        # unknown until the first call
    load_numpy_params(net, _ref_params(ref))
    y = net(tmx.nd.array(x))
    assert y.shape == (4, 16) and net.weight.shape == (16, 7)
    _close(y, want)
    # flatten=False keeps trailing dims; flatten=True folds them
    x3 = _rand(1, 2, 5, 3)
    for flatten, shape in ((False, (2, 5, 8)), (True, (2, 8))):
        ref2 = nn.Dense(8, flatten=flatten)
        ref2.initialize()
        want2 = ref2(nd.array(x3))
        net2 = tnn.Dense(8, flatten=flatten)
        net2.initialize()
        y2 = net2(tmx.nd.array(x3))        # materializes from its own draws
        assert y2.shape == want2.shape == shape
        load_numpy_params(net2, _ref_params(ref2))
        _close(net2(tmx.nd.array(x3)), want2)


def _in_fresh_thread(fn):
    """``fn()`` on a new thread, which has no ``with ctx:`` scope."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:          # re-raised on the caller
            out["error"] = e

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_deferred_init_materializes_on_the_inputs_device():
    """No device given and no scope: the first input's device decides,
    and the draws come from ``initialize``'s seeded generator."""
    def build():
        net = tnn.Dense(16)
        net.initialize(tmx.init.Xavier(), seed=5)   # resolves no device
        return net

    weights = []
    for _ in range(2):
        net = _in_fresh_thread(build)
        assert net.weight.device.type == "meta" and net._deferred_pending
        with pytest.raises(tmx.gluon.DeferredInitializationError):
            net.collect_params()["weight"].data()
        _in_fresh_thread(lambda: net(torch.zeros(2, 7)))
        assert net.weight.device.type == "cpu" and net.weight.shape == (16, 7)
        assert not net._deferred_pending
        weights.append(net.weight.detach().clone())
    assert torch.equal(weights[0], weights[1])
    bound = (3.0 / ((7 + 16) / 2.0)) ** 0.5
    assert 0 < float(weights[0].abs().max()) <= bound
    assert float(net.bias.detach().abs().sum()) == 0.0
    # a known shape needs a device at initialize: without a card, raise
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            _in_fresh_thread(
                lambda: tnn.Dense(16, in_units=7).initialize())


def test_explicit_in_units_no_deferred():
    net = tnn.Dense(4, in_units=3)
    net.initialize()
    assert net.collect_params()["weight"].data().shape == (4, 3)
    assert not net._deferred_pending


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_hybridize_equivalence(act):
    """The hybridized call goes through the compiled form (one
    signature, as the reference's ``_jit_cache`` holds), computes what
    the imperative call computes, and a new ``hybridize`` drops what was
    compiled."""
    x = _rand(2, 5, 20)
    ref = _ref_mlp(x, act)
    want = ref(nd.array(x))
    net = _mlp(tmx, act)
    net.initialize(tmx.init.Xavier())
    load_numpy_params(net, _ref_params(ref))
    imp = net(tmx.nd.array(x))
    assert net._cached_op is None
    net.hybridize()
    assert net._active and net._flags["static_alloc"] is False
    hyb = net(tmx.nd.array(x))
    assert torch.equal(imp.tensor, hyb.tensor)
    _close(hyb, want)
    ref.hybridize()
    ref(nd.array(x))
    assert len(net._cached_op._jit_cache) == \
        len(ref._cached_op._jit_cache) == 1
    net.hybridize(static_alloc=True, static_shape=True)
    assert net._flags == {"static_alloc": True, "static_shape": True}
    assert net._cached_op is None              # recompiles
    assert not net[0]._active                  # children run inside
    _close(net(tmx.nd.array(x)), want)
    assert len(net._cached_op._jit_cache) == 1
    assert net[0]._cached_op is None


def _grads(pkg, net, x, y):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
    loss.backward()
    return {k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def test_hybridize_training_gradients_match():
    x = _rand(3, 6, 12)
    y = onp.random.RandomState(8).randint(0, 10, (6,)).astype("float32")
    ref = _ref_mlp(x, "tanh")
    ref.hybridize()
    want = _grads(mx, ref, x, y)
    for hybridize in (False, True):
        net = _mlp(tmx, "tanh")
        net.initialize(tmx.init.Xavier(), force_reinit=True)
        load_numpy_params(net, _ref_params(ref))
        if hybridize:
            net.hybridize()
        got = _grads(tmx, net, x, y)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])


def test_save_load_parameters(tmp_path):
    x = _rand(4, 2, 6)
    ref = _ref_mlp(x)
    want = ref(nd.array(x))
    ref_file = str(tmp_path / "ref.params")
    ref.save_parameters(ref_file)
    net = _mlp(tmx)
    net.load_parameters(ref_file)         # deferred shapes filled by file
    _close(net(tmx.nd.array(x)), want)
    port_file = str(tmp_path / "port.params")
    net.save_parameters(port_file)
    net2 = _mlp(tmx)
    net2.load_params(port_file)
    _close(net2(tmx.nd.array(x)), want)
    back = _mlp(mx)
    back.load_parameters(port_file)        # and the reference reads it
    _close(back(nd.array(x)), want)


def test_load_parameters_errors(tmp_path):
    net = _mlp(tmx)
    net.initialize()
    net(tmx.nd.zeros((1, 4)))
    f = str(tmp_path / "net.params")
    net.save_parameters(f)
    other = tnn.Dense(3)
    with pytest.raises(tmx.MXNetError):
        other.load_parameters(f)
    other.load_parameters(f, allow_missing=True, ignore_extra=True)
    with pytest.raises(tmx.MXNetError, match="extra"):
        tnn.Dense(32, activation="relu").load_parameters(f)
    with pytest.raises(tmx.MXNetError, match="missing"):
        _mlp(tmx).add(tnn.Dense(3)).load_parameters(f)
    grown = _mlp(tmx).add(tnn.Dense(3, in_units=10))
    grown.load_parameters(f, allow_missing=True)
    assert grown[0].weight.shape == (32, 4)
    # and the reference refuses the port's file the same way
    with pytest.raises(mx.MXNetError):
        nn.Dense(3).load_parameters(f)


def test_collect_params_select():
    ref = _ref_mlp(onp.zeros((1, 4), "float32"))
    net = _mlp(tmx)
    net.initialize()
    net(tmx.nd.zeros((1, 4)))
    all_params = net.collect_params()
    assert list(all_params.keys()) == \
        list(ref._collect_params_with_prefix().keys())
    assert len(all_params) == 4
    only_w = net.collect_params(".*weight")
    assert list(only_w.keys()) == ["0.weight", "1.weight"]


def test_parameter_api():
    for pkg in (mx, tmx):
        p = pkg.gluon.Parameter("weight", shape=(3, 4))
        p.initialize(init=pkg.init.One())
        _close(p.data(), onp.ones((3, 4)))
        p.set_data(pkg.nd.zeros((3, 4)))
        _close(p.data(), onp.zeros((3, 4)))
        assert p.list_ctx()[0] == p.data().context
        assert p.shape == (3, 4) and p.grad_req == "write"
        p.zero_grad()
        p.cast("float16")
        assert p.data().dtype == onp.float16


def test_standalone_parameter_registers_on_its_block():
    """``params.get`` and an assigned standalone Parameter register on
    the block, so ``hybrid_forward`` receives them and ``collect_params``
    lists them; ``lr_mult``/``grad_req`` set at creation stay."""

    class Scale(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.w = self.params.get("w", shape=(3,), init="ones")
            self.b = tmx.gluon.Parameter("b", shape=(3,), lr_mult=0.5,
                                         init=tmx.init.Constant(2.0))

        def hybrid_forward(self, F, x, w, b):
            return x * w + b

    blk = Scale()
    assert list(blk.collect_params().keys()) == ["w", "b"]
    assert list(blk.params.keys()) == ["w", "b"]
    blk.initialize()
    out = blk(tmx.nd.array(onp.arange(3, dtype="float32")))
    _close(out, onp.arange(3) + 2.0)
    assert blk.collect_params()["b"].lr_mult == 0.5
    assert blk.params.get("w") is not None and blk.w.shape == (3,)
    # a ParameterDict of its own makes standalone parameters, as the
    # reference's does, named by its prefix
    for pkg in (mx, tmx):
        pd = pkg.gluon.ParameterDict("pre_")
        p = pd.get("w", shape=(2,), init="ones")
        assert p.name == "pre_w" and pd.get("w") is p and len(pd) == 1
        p.initialize()
        _close(p.data(), onp.ones(2))


def test_constant_parameter():
    want = gluon.Constant("c", [[1.0, 2.0]])
    c = tmx.gluon.Constant("c", [[1.0, 2.0]])
    assert c.grad_req == want.grad_req == "null"
    _close(c.data(), want.data())
    assert c.data().dtype == want.data().dtype == onp.float32


def test_sequential_container_api():
    for pkg in (mx, tmx):
        for cls in (pkg.gluon.nn.Sequential, pkg.gluon.nn.HybridSequential):
            net = cls()
            net.add(pkg.gluon.nn.Dense(4), pkg.gluon.nn.Dense(2))
            assert len(net) == 2
            assert isinstance(net[0], pkg.gluon.nn.Dense)
            assert isinstance(net[-1], pkg.gluon.nn.Dense)
            sliced = net[0:1]
            assert len(sliced) == 1 and type(sliced) is cls
            assert [type(b).__name__ for b in net] == ["Dense", "Dense"]
    x = _rand(5, 3, 6)
    mx.random.seed(3)
    ref = nn.Sequential()
    ref.add(nn.Dense(4, activation="sigmoid"), nn.Dense(2))
    ref.initialize()
    want = ref(nd.array(x))
    net = tnn.Sequential()
    net.add(tnn.Dense(4, activation="sigmoid"), tnn.Dense(2))
    load_numpy_params(net, _ref_params(ref))
    _close(net(tmx.nd.array(x)), want)


def test_embedding_layer():
    idx = onp.array([[1, 2], [3, 25]], "int32")     # 25 clips to the table
    ref = nn.Embedding(20, 8)
    ref.initialize()
    want = ref(nd.array(idx, dtype="int32"))
    emb = tnn.Embedding(20, 8)
    load_numpy_params(emb, _ref_params(ref))
    out = emb(tmx.nd.array(idx, dtype="int32"))
    assert out.shape == (2, 2, 8)
    _close(out, want)


ACTIVATIONS = {
    "LeakyReLU": lambda n: n.LeakyReLU(0.1),
    "ELU": lambda n: n.ELU(),
    "ELU_alpha": lambda n: n.ELU(0.5),
    "SELU": lambda n: n.SELU(),
    "GELU": lambda n: n.GELU(),
    "GELU_tanh": lambda n: n.GELU(approximation="tanh"),
    "Swish": lambda n: n.Swish(),
    "Swish_beta": lambda n: n.Swish(2.0),
    "softrelu": lambda n: n.Activation("softrelu"),
    "sigmoid": lambda n: n.Activation("sigmoid"),
    "softsign": lambda n: n.Activation("softsign"),
    "Identity": lambda n: n.Identity(),
    "Flatten": lambda n: n.Flatten(),
    "PReLU": lambda n: n.PReLU(),
    "PReLU_channels": lambda n: n.PReLU(in_channels=5),
}


@pytest.mark.parametrize("case", sorted(ACTIVATIONS))
def test_prelu_elu_selu_gelu(case):
    x = _rand(6, 3, 5) * 2
    ref = ACTIVATIONS[case](nn)
    ref.initialize()
    xr = nd.array(x)
    xr.attach_grad()
    with autograd.record():
        want = ref(xr)
    want.backward()
    blk = ACTIVATIONS[case](tnn)
    blk.initialize()
    xt = tmx.nd.array(x)
    xt.attach_grad()
    with tmx.autograd.record():
        y = blk(xt)
    y.backward()
    assert y.shape == want.shape
    _close(y, want)
    _close(xt.grad, xr.grad)


def test_block_apply_and_repr():
    net = _mlp(tmx)
    net.initialize()
    seen = []
    net.apply(lambda b: seen.append(type(b).__name__))
    assert seen == ["Dense", "Dense", "HybridSequential"]
    ref = _ref_mlp(onp.zeros((1, 4), "float32"))
    net(tmx.nd.zeros((1, 4)))
    assert repr(net) == repr(ref)
    assert "Dense(4 -> 32, relu)" in repr(net)


def test_lambda_blocks():
    lam = tnn.HybridLambda(lambda F, x: F.relu(x))
    y = lam(tmx.nd.array([-1.0, 1.0]))
    _close(y, onp.array([0.0, 1.0]))
    lam2 = tnn.Lambda("tanh")
    x = onp.array([0.0, 0.5, -2.0], "float32")
    _close(lam2(tmx.nd.array(x)), nn.Lambda("tanh")(nd.array(x)))
    lam3 = tnn.HybridLambda("sigmoid")
    _close(lam3(tmx.nd.array(x)), nn.HybridLambda("sigmoid")(nd.array(x)))
    # a tensor caller gets a tensor
    assert isinstance(lam2(torch.from_numpy(x)), torch.Tensor)


def test_static_arg_changes_recompile():
    class Scaler(tnn.HybridBlock):
        def forward(self, x, flag):
            return x + 1 if flag else x + 2

    net = Scaler()
    net.initialize()
    net.hybridize()
    x = tmx.nd.array([1.0])
    assert net(x, True).asscalar() == 2.0
    assert net(x, False).asscalar() == 3.0
    # one compiled signature per static value, each reused
    assert net(x, True).asscalar() == 2.0
    assert len(net._cached_op._jit_cache) == 2

    class RefScaler(gluon.HybridBlock):
        def forward(self, x, flag):
            return x + 1 if flag else x + 2

    ref = RefScaler()
    ref.initialize()
    ref.hybridize()
    for flag in (True, False, True):
        ref(nd.array([1.0]), flag)
    assert len(ref._cached_op._jit_cache) == 2


def test_explicit_initializer_honored():
    """The initializer attached to a parameter wins over the name rule."""
    net = tnn.Dense(3, in_units=2, bias_initializer="ones")
    net.initialize()
    want = nn.Dense(3, in_units=2, bias_initializer="ones")
    want.initialize()
    _close(net.collect_params()["bias"].data(), want.bias.data())
    _close(net.collect_params()["bias"].data(), onp.ones(3))
    p = tmx.gluon.Parameter("h2h_bias", shape=(8,),
                            init=tmx.init.LSTMBias(forget_bias=1.0))
    p.initialize()
    q = gluon.Parameter("h2h_bias", shape=(8,),
                        init=mx.init.LSTMBias(forget_bias=1.0))
    q.initialize()
    onp.testing.assert_array_equal(p.data().asnumpy(), q.data().asnumpy())
    ref = onp.zeros(8, dtype=onp.float32)
    ref[2:4] = 1.0
    onp.testing.assert_array_equal(p.data().asnumpy(), ref)


# ---------------------------------------------------------- block API

def test_block_naming_hooks_and_summary(capsys):
    net = tnn.HybridSequential(prefix="mlp_")
    assert net.prefix == "mlp_" and net.name == "mlp"
    with net.name_scope():
        d = tnn.Dense(4, in_units=3)
    assert d.prefix.startswith("dense") and d.name == d.prefix[:-1]
    net.register_child(d)
    net.register_child(tnn.Dense(2, in_units=4), "head")
    assert list(net.collect_params().keys()) == \
        ["0.weight", "0.bias", "head.weight", "head.bias"]
    net.initialize()
    seen = []
    net.register_forward_pre_hook(lambda b, args: seen.append("pre"))
    net.register_forward_hook(
        lambda b, args, out: seen.append(tuple(out.shape)))
    net(tmx.nd.zeros((5, 3)))
    assert seen == ["pre", (5, 2)]
    net.summary()
    out = capsys.readouterr().out
    assert "Total params: 26" in out and "Dense" in out
    with pytest.raises(tmx.MXNetError):
        tnn.Dense(2, params=net.params)


# ---------------------------------------- the canonical MNIST-shaped program

def _mnist_batches(n, batch=16, seed=0):
    """MNIST-shaped batches: pixels in [0, 1), labels of a fixed random
    linear teacher over the pixels."""
    rs = onp.random.RandomState(seed)
    teacher = rs.randn(784, 10).astype("float32")
    out = []
    for _ in range(n):
        x = rs.rand(batch, 1, 28, 28).astype("float32")
        out.append((x, (x.reshape(batch, -1) @ teacher).argmax(1)
                    .astype("float32")))
    return out


def _skill_program(pkg, params_file, batches):
    """The canonical program: HybridSequential(Flatten, Dense(128, relu),
    Dense(10)), Xavier, hybridize(static_alloc), SGD 0.1, SoftmaxCE; the
    weights come from ``params_file``."""
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Flatten(),
            pkg.gluon.nn.Dense(128, activation="relu"),
            pkg.gluon.nn.Dense(10))
    net.initialize(pkg.init.Xavier())
    net.load_parameters(params_file)
    net.hybridize(static_alloc=True)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, grads = [], None
    for x, y in batches:
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
        loss.backward()
        if grads is None:
            grads = {k: p.grad().asnumpy() for k, p in
                     net._collect_params_with_prefix().items()}
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses, grads, {k: p.data().asnumpy() for k, p in
                           net._collect_params_with_prefix().items()}


def test_skill_program_matches_reference(tmp_path):
    batches = _mnist_batches(3)
    mx.random.seed(11)
    seed_net = nn.HybridSequential()
    seed_net.add(nn.Flatten(), nn.Dense(128, activation="relu"),
                 nn.Dense(10))
    seed_net.initialize(mx.init.Xavier())
    seed_net(nd.array(batches[0][0]))
    f = str(tmp_path / "mlp.params")
    seed_net.save_parameters(f)
    want = _skill_program(mx, f, batches)
    got = _skill_program(tmx, f, batches)
    assert got[0] == pytest.approx(want[0], rel=TOL)
    assert got[0][-1] < got[0][0]
    for g, w in zip(got[1:], want[1:]):
        assert sorted(g) == sorted(w)
        for k in w:
            onp.testing.assert_allclose(g[k], w[k], rtol=0, atol=TOL,
                                        err_msg=k)


# ------------------------------------------------------------ initializers

DETERMINISTIC = {
    "zeros": lambda i: i.Zero(),
    "ones": lambda i: i.One(),
    "constant": lambda i: i.Constant(0.3),
    "constant_array": lambda i: i.Constant(
        onp.array([[1.0], [2.0], [3.0], [4.0]], "float32")),
    "bilinear": lambda i: i.Bilinear(),
    "lstm_bias": lambda i: i.LSTMBias(forget_bias=2.5),
    "create_zeros": lambda i: i.create("zeros"),
    "create_ones": lambda i: i.create("ones"),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_deterministic_initializers_match_bit_for_bit(case):
    shape = (4, 3, 5, 6) if case == "bilinear" else (4, 6)
    want = nd.zeros(shape)
    DETERMINISTIC[case](mx.init)("w_weight", want)
    got = tmx.nd.zeros(shape)
    DETERMINISTIC[case](tmx.init)("w_weight", got)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_initializer_name_rules_match():
    """gamma → 1, beta/bias/running_mean → 0, running_var → 1, and an
    explicit initializer skips the rules."""
    for name in ("ln_gamma", "ln_beta", "fc_bias", "bn_running_mean",
                 "bn_running_var", "bn_moving_var"):
        want = nd.ones((3,)) * 7
        mx.init.Uniform()(name, want)
        got = tmx.nd.ones((3,)) * 7
        tmx.init.Uniform()(name, got)
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    got = tmx.nd.zeros((3,))
    tmx.init.One()("fc_bias", got, explicit=True)
    onp.testing.assert_array_equal(got.asnumpy(), onp.ones(3))


@pytest.mark.parametrize("factor", ["avg", "in", "out"])
@pytest.mark.parametrize("rnd", ["uniform", "gaussian"])
def test_xavier_fan_arithmetic_and_bounds(factor, rnd):
    shape = (64, 32, 3, 3)
    fan_in, fan_out = 32 * 9, 64 * 9
    f = {"avg": (fan_in + fan_out) / 2, "in": fan_in, "out": fan_out}[factor]
    scale = (2.0 / f) ** 0.5
    init = tmx.init.Xavier(rnd_type=rnd, factor_type=factor, magnitude=2)
    assert init.scale(shape) == pytest.approx(scale)
    t = tmx.nd.zeros(shape)
    tmx.random.seed(1)
    init("conv_weight", t)
    a = t.asnumpy()
    want = nd.zeros(shape)
    mx.init.Xavier(rnd_type=rnd, factor_type=factor, magnitude=2)(
        "conv_weight", want)
    if rnd == "uniform":
        assert abs(a).max() <= scale and abs(want.asnumpy()).max() <= scale
        assert a.std() == pytest.approx(scale / 3 ** 0.5, rel=0.05)
    else:
        assert a.std() == pytest.approx(scale, rel=0.05)
    assert a.std() == pytest.approx(want.asnumpy().std(), rel=0.05)
    assert abs(a.mean()) < 0.05 * scale
    with pytest.raises(ValueError):
        init("b_weight", tmx.nd.zeros((4,)))


@pytest.mark.parametrize("shape", [(8, 5), (5, 8), (6, 2, 2)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape):
    t = tmx.nd.zeros(shape)
    tmx.init.Orthogonal(scale=1.5)("w_weight", t)
    m = t.asnumpy().reshape(shape[0], -1) / 1.5
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    onp.testing.assert_allclose(gram, onp.eye(gram.shape[0]), atol=1e-5)
    want = nd.zeros(shape)
    mx.init.Orthogonal(scale=1.5)("w_weight", want)
    wm = want.asnumpy().reshape(shape[0], -1) / 1.5
    wg = wm @ wm.T if wm.shape[0] <= wm.shape[1] else wm.T @ wm
    onp.testing.assert_allclose(gram, wg, atol=1e-5)


@pytest.mark.parametrize("case", ["uniform", "normal", "msraprelu"])
def test_random_initializers_keep_the_distribution(case):
    shape = (128, 96)
    make = {"uniform": lambda i: i.Uniform(0.2),
            "normal": lambda i: i.Normal(0.3),
            "msraprelu": lambda i: i.MSRAPrelu(slope=0.1)}[case]
    t, want = tmx.nd.zeros(shape), nd.zeros(shape)
    make(tmx.init)("fc_weight", t)
    make(mx.init)("fc_weight", want)
    a, w = t.asnumpy(), want.asnumpy()
    if case == "uniform":
        assert abs(a).max() <= 0.2 and abs(w).max() <= 0.2
    assert a.std() == pytest.approx(w.std(), rel=0.05)
    assert abs(a.mean()) < 0.05 * w.std()
    assert make(tmx.init).dumps() == make(mx.init).dumps()


def test_init_alias_and_create():
    assert tmx.init is tmx.initializer
    for name in ("zeros", "ones", "uniform", "normal", "xavier",
                 "orthogonal", "msraprelu", "bilinear", "lstmbias",
                 "constant"):
        assert type(tmx.init.create(name)).__name__.lower() == \
            type(mx.init.create(name)).__name__.lower()
    assert isinstance(tmx.init.create(None), tmx.init.Uniform)
    with pytest.raises(tmx.MXNetError):
        tmx.init.create("no_such_init")


# ------------------------------------------------------------ gluon.utils

def test_split_data_and_split_and_load():
    x = _rand(9, 6, 4)
    for n, even in ((1, True), (2, True), (3, True), (4, False)):
        want = gluon.utils.split_data(nd.array(x), n, even_split=even)
        got = tmx.gluon.utils.split_data(tmx.nd.array(x), n,
                                         even_split=even)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(ValueError):
        tmx.gluon.utils.split_data(tmx.nd.array(x), 4)
    got = tmx.gluon.split_and_load(x, [tmx.cpu(0), tmx.cpu(0)], batch_axis=1)
    assert [g.shape for g in got] == [(6, 2), (6, 2)]
    assert got[0].context == tmx.cpu(0)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 100.0])
def test_clip_global_norm_matches_reference(max_norm):
    """The joint norm is capped at ``max_norm`` (the contract of the
    reference's in-graph clip, ``tests/test_guardrails.py``), the norm
    before clipping is returned, and small arrays pass unchanged."""
    arrays = [_rand(10, 4, 3), _rand(11, 7)]
    want = [nd.array(a) for a in arrays]
    got = [tmx.nd.array(a) for a in arrays]
    n_want = gluon.utils.clip_global_norm(want, max_norm)
    n_got = tmx.gluon.utils.clip_global_norm(got, max_norm)
    assert n_got == pytest.approx(n_want, rel=1e-6)
    after = onp.sqrt(sum((g.asnumpy() ** 2).sum() for g in got))
    assert after <= max_norm * (1 + 1e-6)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6,
                                    atol=1e-7)
    with pytest.warns(UserWarning, match="nan or inf"):
        tmx.gluon.utils.clip_global_norm([tmx.nd.array([float("inf")])], 1.0)
