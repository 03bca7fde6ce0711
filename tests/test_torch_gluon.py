"""The port's Gluon training surface against the JAX package's.

The MXNet loop — ``mx.nd`` inputs, ``with autograd.record()``, a
``gluon.loss``, ``loss.backward()``, ``gluon.Trainer.step`` — runs on the
GPT-2 of ``tests/test_torch_train.py`` (vocab 512, 128 units, 2 layers,
2 heads, B 4 x T 32, the reference's weights copied in) against the
reference's own Gluon loop, and against the port's ``ShardedTrainer``.
Tolerances are that file's: losses relative 1e-5, step-1 gradients
max-abs 1e-5, parameters max-abs 1e-4 after Adam steps.  Each loss
block is held to the reference's at rtol 1e-5, atol 1e-6.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu.models import get_gpt2 as jget_gpt2
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tlm_loss
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.utils.convert import load_numpy_params

CFG = dict(vocab_size=512, units=128, num_layers=2, num_heads=2,
           max_length=256, dropout=0.0)
B, T = 4, 32
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-4
WEIGHT_SEED = 0


def _batch(seed):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, 512, (B, T)).astype("int32"),
            rs.randint(0, 512, (B, T)).astype("int32"))


@pytest.fixture(scope="module")
def params():
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(WEIGHT_SEED)
    jn.initialize()
    return {k: p.data().asnumpy()
            for k, p in jn._collect_params_with_prefix().items()}


def _ref_net(params):
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(WEIGHT_SEED)
    jn.initialize()
    for k, p in jn._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    return jn


def _port_net(params):
    return load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                             params)


def _gluon_loop(pkg, net, steps, seed0=0):
    """The canonical MXNet loop; returns the losses (batch means), the
    step-1 gradients by structural name, and the trainer."""
    structural = (net._collect_params_with_prefix() if pkg is mx
                  else net.collect_params())
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": LR})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, grads = [], None
    for step in range(steps):
        toks, labels = _batch(seed0 + step)
        x = pkg.nd.array(toks, dtype="int32")
        y = pkg.nd.array(labels, dtype="int32")
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        if grads is None:
            grads = {k: p.grad().asnumpy() for k, p in structural.items()}
        trainer.step(B)
        assert loss.shape == (B,)
        losses.append(float(loss.mean().asscalar()))
    return losses, grads, trainer


def _port_params(net):
    return {k: p.detach().numpy() for k, p in net.named_parameters()}


def test_gluon_loop_matches_reference_gluon_loop(params):
    jn = _ref_net(params)
    want_losses, want_grads, _ = _gluon_loop(mx, jn, 3)
    with tmx.cpu():
        tn = _port_net(params)
        losses, grads, _ = _gluon_loop(tmx, tn, 3)
    assert losses == pytest.approx(want_losses, rel=LOSS_RTOL)
    assert list(grads) == list(want_grads)
    for k, g in grads.items():
        onp.testing.assert_allclose(g, want_grads[k], atol=GRAD_TOL, rtol=0,
                                    err_msg=k)
    for k, v in _port_params(tn).items():
        onp.testing.assert_allclose(
            v, jn._collect_params_with_prefix()[k].data().asnumpy(),
            atol=PARAM_TOL, rtol=0, err_msg=k)


def test_gluon_loop_matches_sharded_trainer(params):
    """The port's two trainers on one batch stream: SoftmaxCE per sample
    with ``step(B)`` against ``gpt2_lm_loss``'s token mean, and a loss
    block handed to ``ShardedTrainer`` as a plain tensor loss."""
    with tmx.cpu():
        tn = _port_net(params)
        losses, _g, trainer = _gluon_loop(tmx, tn, 3)
    assert trainer.optimizer.num_update == 3
    for loss in (tlm_loss, tmx.gluon.loss.SoftmaxCrossEntropyLoss()):
        sn = _port_net(params)
        st = ShardedTrainer(sn, "adam", loss=loss,
                            optimizer_params={"learning_rate": LR})
        got = [float(st.step(*_batch(i))) for i in range(3)]
        assert got == pytest.approx(losses, rel=LOSS_RTOL)
        for k, v in _port_params(sn).items():
            onp.testing.assert_allclose(v, _port_params(tn)[k],
                                        atol=PARAM_TOL, rtol=0, err_msg=k)


def test_lm_loss_and_sharded_trainer_take_ndarrays(params):
    """``gpt2_lm_loss`` on NDArrays gives an NDArray (a graph only inside
    ``record()``) equal to its tensor form; ``ShardedTrainer.step`` takes
    NDArray batches (``bench.py``'s form)."""
    toks, labels = _batch(0)
    with tmx.cpu():
        net = _port_net(params)
        x, y = tmx.nd.array(toks, dtype="int32"), tmx.nd.array(labels)
        with tmx.autograd.record():
            loss = tlm_loss(net(x), y)
        assert isinstance(loss, tmx.nd.NDArray) and loss.shape == ()
        loss.backward()
        want = tlm_loss(net(torch.from_numpy(toks)), torch.from_numpy(labels))
        assert float(loss.asscalar()) == pytest.approx(float(want), rel=1e-6)
        assert not tlm_loss(net(x), y).tensor.requires_grad
        ref = torch.autograd.grad(want, [net.wte.weight])[0]
        onp.testing.assert_allclose(
            net.collect_params()["wte.weight"].grad().asnumpy(), ref.numpy(),
            atol=1e-7, rtol=0)
        tr = ShardedTrainer(_port_net(params), "adam", loss=tlm_loss,
                            optimizer_params={"learning_rate": LR})
        got = tr.step(x, y)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


def _dense_pair(pkg, units=8, in_units=16, scale=0.1):
    """A Dense layer with seeded weights (the build of
    ``tests/test_parallel.py``'s trainer comparison)."""
    net = pkg.gluon.nn.Dense(units, in_units=in_units)
    if pkg is mx:
        net.initialize()
    else:
        net.initialize(ctx=tmx.cpu())
    for i, k in enumerate(["weight", "bias"]):
        p = net._collect_params_with_prefix()[k] if pkg is mx else \
            net.collect_params()[k]
        onp.random.seed(1000 + i)
        p.set_data(pkg.nd.array(
            onp.random.randn(*p.shape).astype("float32") * scale))
    return net


def test_one_device_trainers_agree_on_a_dense_layer():
    """The one-device form of the reference's SPMD-vs-imperative test:
    one SGD step of ``gluon.Trainer`` equals ``ShardedTrainer``'s."""
    rs = onp.random.RandomState(1)
    x = rs.randn(16, 16).astype("float32")
    y = rs.randn(16, 8).astype("float32")
    with tmx.cpu():
        net1 = _dense_pair(tmx)
        tr1 = tmx.gluon.Trainer(net1.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        with tmx.autograd.record():
            loss = ((net1(tmx.nd.array(x)) - tmx.nd.array(y)) ** 2).mean()
        loss.backward()
        tr1.step(1, ignore_stale_grad=True)
        net2 = _dense_pair(tmx)
        ShardedTrainer(net2, "sgd", loss=lambda o, l: ((o - l) ** 2).mean(),
                       optimizer_params={"learning_rate": 0.1}).step(
            tmx.nd.array(x), tmx.nd.array(y))
    for (n, a), b in zip(net1.named_parameters(), net2.parameters()):
        onp.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                    rtol=2e-5, atol=2e-6, err_msg=n)
    ref = _dense_pair(mx)
    jt = mx.gluon.Trainer(ref.collect_params(), "sgd", {"learning_rate": 0.1})
    with mx.autograd.record():
        jl = ((ref(mx.nd.array(x)) - mx.nd.array(y)) ** 2).mean()
    jl.backward()
    jt.step(1)
    for k, p in ref._collect_params_with_prefix().items():
        onp.testing.assert_allclose(
            net1.collect_params()[k].data().asnumpy(), p.data().asnumpy(),
            rtol=2e-5, atol=2e-6, err_msg=k)


# ------------------------------------------------------------------ losses

_rs = onp.random.RandomState(5)


def _R(*s):
    return _rs.uniform(-1.5, 1.5, s).astype("float32")


def _P(*s):
    return _rs.uniform(0.05, 0.95, s).astype("float32")


def _SIGN(*s):
    return _rs.choice([-1.0, 1.0], s).astype("float32")


def _BIN(*s):
    return _rs.randint(0, 2, s).astype("float32")


def _DIST(*s):
    e = onp.exp(_R(*s))
    return (e / e.sum(-1, keepdims=True)).astype("float32")


LOSSES = {
    "L2": ("L2Loss", {}, [_R(4, 3), _R(4, 3)]),
    "L2_weighted": ("L2Loss", {"weight": 0.7},
                    [_R(4, 3), _R(4, 3), _P(4, 1)]),
    "L1": ("L1Loss", {}, [_R(4, 3), _R(4, 3)]),
    "SigmoidBCE": ("SigmoidBCELoss", {}, [_R(4, 3), _BIN(4, 3)]),
    "SigmoidBCE_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                                {"from_sigmoid": True},
                                [_P(4, 3), _BIN(4, 3)]),
    "SoftmaxCE_sparse": ("SoftmaxCrossEntropyLoss", {},
                         [_R(4, 5), _rs.randint(0, 5, (4,)).astype("int32")]),
    "SoftmaxCE_sequence": ("SoftmaxCELoss", {},
                           [_R(2, 3, 5),
                            _rs.randint(0, 5, (2, 3)).astype("int32")]),
    "SoftmaxCE_dense": ("SoftmaxCELoss", {"sparse_label": False},
                        [_R(4, 5), _DIST(4, 5)]),
    "SoftmaxCE_from_logits": ("SoftmaxCELoss", {"from_logits": True},
                              [_R(4, 5) - 2,
                               _rs.randint(0, 5, (4,)).astype("int32")]),
    "KLDiv": ("KLDivLoss", {"from_logits": False}, [_R(4, 5), _DIST(4, 5)]),
    "Huber": ("HuberLoss", {"rho": 0.5}, [_R(4, 3), _R(4, 3)]),
    "Hinge": ("HingeLoss", {}, [_R(4, 3), _SIGN(4, 3)]),
    "SquaredHinge": ("SquaredHingeLoss", {"margin": 0.5},
                     [_R(4, 3), _SIGN(4, 3)]),
    "Logistic_signed": ("LogisticLoss", {}, [_R(4, 3), _SIGN(4, 3)]),
    "Logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        [_R(4, 3), _BIN(4, 3)]),
    "Triplet": ("TripletLoss", {"margin": 0.5},
                [_R(4, 3), _R(4, 3), _R(4, 3)]),
    "CosineEmbedding": ("CosineEmbeddingLoss", {"margin": 0.1},
                        [_R(4, 3), _R(4, 3), _SIGN(4)]),
    "PoissonNLL_logits": ("PoissonNLLLoss", {}, [_R(4, 3), _P(4, 3) * 4]),
    "PoissonNLL_full": ("PoissonNLLLoss", {"from_logits": False,
                                           "compute_full": True},
                        [_P(4, 3) * 3, _P(4, 3) * 4]),
}


def _loss_run(pkg, name, kw, inputs):
    xs = [pkg.nd.array(a) for a in inputs]
    for x, a in zip(xs, inputs):
        if a.dtype == onp.float32:
            x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.gluon.loss, name)(**kw)(*xs)
    out.backward()
    return [out.asnumpy()] + [x.grad.asnumpy() for x, a in zip(xs, inputs)
                              if a.dtype == onp.float32]


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_reference(case):
    name, kw, inputs = LOSSES[case]
    want = _loss_run(mx, name, kw, inputs)
    with tmx.cpu():
        got = _loss_run(tmx, name, kw, inputs)
    assert got[0].shape == want[0].shape
    for a, b in zip(got, want):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- trainer and state

def _dense_steps(pkg, net, trainer, steps, seed=0):
    rs = onp.random.RandomState(seed)
    for _ in range(steps):
        x = pkg.nd.array(rs.randn(6, 16).astype("float32"))
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(6)


def _dense_params(pkg, net):
    cp = net._collect_params_with_prefix() if pkg is mx else \
        net.collect_params()
    return {k: p.data().asnumpy() for k, p in cp.items()}


def test_save_and_load_states_round_trip_and_cross_package(tmp_path):
    """Two Adam steps, save_states; a fresh trainer on the same weights
    loads them and its third step equals the first trainer's, bit for
    bit.  The states file is the reference's format: the reference's file
    resumes the port the same way (a Dense layer, whose sorted names
    index the parameters alike in both packages)."""
    opt = {"learning_rate": 0.01}
    with tmx.cpu():
        a = _dense_pair(tmx)
        ta = tmx.gluon.Trainer(a.collect_params(), "adam", opt)
        _dense_steps(tmx, a, ta, 2)
        fname = str(tmp_path / "port.states")
        ta.save_states(fname)
        b = _dense_pair(tmx)
        for k, v in _dense_params(tmx, a).items():
            b.collect_params()[k].set_data(v)
        tb = tmx.gluon.Trainer(b.collect_params(), "adam", opt)
        tb.load_states(fname)
        assert tb.optimizer.num_update == 2
        for net, tr in ((a, ta), (b, tb)):
            _dense_steps(tmx, net, tr, 1, seed=7)
    for k, v in _dense_params(tmx, a).items():
        onp.testing.assert_array_equal(v, _dense_params(tmx, b)[k])

    ref = _dense_pair(mx)
    tr = mx.gluon.Trainer(ref.collect_params(), "adam", opt)
    _dense_steps(mx, ref, tr, 2)
    ref_file = str(tmp_path / "ref.states")
    tr.save_states(ref_file)
    with tmx.cpu():
        c = _dense_pair(tmx)
        for k, v in _dense_params(mx, ref).items():
            c.collect_params()[k].set_data(v)
        tc = tmx.gluon.Trainer(c.collect_params(), "adam", opt)
        tc.load_states(ref_file)
        _dense_steps(tmx, c, tc, 1, seed=7)
    _dense_steps(mx, ref, tr, 1, seed=7)
    for k, v in _dense_params(mx, ref).items():
        onp.testing.assert_allclose(_dense_params(tmx, c)[k], v, atol=1e-6,
                                    rtol=0, err_msg=k)


def test_state_order_differs_from_the_reference_on_gpt2(params):
    """A divergence (ROADMAP C): the reference indexes optimizer states by
    its sorted ``p.name`` keys, the port by its sorted structural names,
    so a GPT-2 states file does not carry across packages."""
    jn = _ref_net(params)
    by_name = {p.name: s for s, p in jn._collect_params_with_prefix().items()}
    ref_order = [by_name[k] for k in sorted(jn.collect_params().keys())]
    with tmx.cpu():
        port_order = sorted(_port_net(params).collect_params().keys())
    assert sorted(ref_order) == port_order and ref_order != port_order


def test_amp_trainer_skips_an_overflowed_step():
    """Mirrors the reference's guardrails test: a NaN gradient skips the
    update and halves the scale; a clean step updates."""
    rs = onp.random.RandomState(0)
    with tmx.cpu():
        net = tnn.Dense(2, in_units=4)
        net.initialize(ctx=tmx.cpu())
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        tamp.init_trainer(trainer, loss_scaler=tamp.LossScaler(
            init_scale=1024.0, scale_factor=2.0, scale_window=2000))
        X = tmx.nd.array(rs.randn(8, 4).astype("float32"))
        y = tmx.nd.array((onp.arange(8) % 2).astype("float32"))
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        with tmx.autograd.record():
            with tamp.scale_loss(loss_fn(net(X), y), trainer) as scaled:
                scaled.backward()
        weight = net.collect_params()["weight"]
        before = weight.data().asnumpy().copy()
        g = weight.grad()
        g *= float("nan")                      # poison the gradient
        trainer.step(8)
        onp.testing.assert_array_equal(weight.data().asnumpy(), before)
        assert trainer._amp_loss_scaler.loss_scale == 512.0
        assert trainer.skipped_steps == 1
        with tmx.autograd.record():
            with tamp.scale_loss(loss_fn(net(X), y), trainer) as scaled:
                scaled.backward()
        trainer.step(8)
        assert not onp.array_equal(weight.data().asnumpy(), before)
    js, ts = jamp.LossScaler(8.0, 2.0, 2), tamp.LossScaler(8.0, 2.0, 2)
    for skip in [False, False, True, False, True, True]:
        js.update_scale(skip)
        ts.update_scale(skip)
        assert ts.loss_scale == js.loss_scale


def test_trainer_refuses_what_one_device_cannot_do():
    with tmx.cpu():
        net = tnn.Dense(2, in_units=3)
        net.initialize()
        for kv in ("dist_sync", "dist_device_sync", "nccl"):
            with pytest.raises(tmx.MXNetError, match="queue A6"):
                tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore=kv)
        with pytest.raises(tmx.MXNetError, match="queue A6"):
            tmx.gluon.Trainer(net.collect_params(), "sgd",
                              update_on_kvstore=True)
        for kv in (None, "device", "local"):
            tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore=kv)


def test_nothing_runs_on_the_cpu_unasked():
    """Without a card, a net built with no device and a Trainer over it
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tget_gpt2("gpt2_124m", **CFG)
    net = tnn.Dense(2, in_units=3)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        net.initialize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(tmx.MXNetError, match="not been initialized"):
        trainer.step(1)


def test_parameter_handles_share_storage():
    with tmx.cpu():
        net = tnn.Dense(3, in_units=2)
        net.initialize()
        params = net.collect_params()
        assert list(params.keys()) == ["weight", "bias"]
        assert list(net.collect_params("b.*").keys()) == ["bias"]
        w = params["weight"]
        assert w.shape == (3, 2) and w.dtype == onp.float32
        w.data()[:] = 0.5                        # writes through
        assert float(net.weight.detach().sum()) == 3.0
        w.set_data(onp.ones((3, 2), "float32"))
        assert float(net.weight.detach().sum()) == 6.0
        x = tmx.nd.array(onp.ones((4, 2), "float32"))
        with tmx.autograd.record():
            out = net(x)
        assert isinstance(out, tmx.nd.NDArray)
        out.backward()
        g = w.grad()
        assert g.tensor is net.weight.grad
        onp.testing.assert_allclose(g.asnumpy(), onp.full((3, 2), 4.0))
        assert not net(x).tensor.requires_grad   # outside record()
        assert isinstance(net(torch.ones(1, 2)), torch.Tensor)
        # lr_mult 0 and grad_req 'null' freeze a parameter; the settings
        # survive a cast and every handle sees them
        params["bias"].lr_mult = 0.0
        w.grad_req = "null"
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1.0})
        with tmx.autograd.record():
            out = net(x)
        out.backward()
        before = {k: p.data().asnumpy() for k, p in params.items()}
        tr.step(1)
        for k, p in net.collect_params().items():
            onp.testing.assert_array_equal(p.data().asnumpy(), before[k])
        net.cast("float16")
        assert net.collect_params()["bias"].lr_mult == 0.0
        assert net.collect_params()["weight"].grad_req == "null"
        assert net.collect_params()["weight"].dtype == onp.float16


def test_parameter_dict_save_load_and_reinitialize(tmp_path):
    with tmx.cpu():
        net = tnn.Dense(3, in_units=2)
        net.initialize(seed=3)
        fname = str(tmp_path / "dense.params")
        net.collect_params().save(fname)
        other = tnn.Dense(3, in_units=2)
        other.collect_params().load(fname, ctx=tmx.cpu())
        for (k, a), b in zip(net.named_parameters(), other.parameters()):
            assert torch.equal(a, b), k
        other.collect_params().initialize(force_reinit=True)
        assert not torch.equal(net.weight, other.weight)
        other.collect_params().zero_grad()
        other.load_parameters(fname)
        assert torch.equal(net.weight, other.weight)
