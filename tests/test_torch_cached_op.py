"""The port's hybridized block (``gluon/cached_op.py``) against the JAX
package's hybridized block, from the same numpy weights and inputs.

On the CPU the CachedOp runs its programs' functions on their static
buffers (the card replays them as CUDA graphs; ``test_torch_cuda.py``
holds the replays to these calls).  Tolerances: outputs and gradients
1e-5 of max-abs for the MLP and the convolution net (float32 sums in
another order); BatchNorm's moving statistics 1e-5 after 3 recorded
steps; the routed GPT-2's logits and loss 1e-5, each gradient 1e-4 of
its max-abs (``test_torch_moe.py``'s).  The number of compiled
signatures equals the reference's ``len(_cached_op._jit_cache)`` after
the same calls.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.models import gpt2_lm_loss as jloss
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.utils.convert import load_numpy_params

TOL = 1e-5
MOE_CFG = dict(vocab_size=128, units=32, num_layers=2, num_heads=4,
               max_length=64, dropout=0.0, num_experts=2, moe_every=2)
MOE_GRAD_TOL = 1e-4

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _close(a, b, tol=TOL):
    a = a.asnumpy() if hasattr(a, "asnumpy") else onp.asarray(a)
    b = b.asnumpy() if hasattr(b, "asnumpy") else onp.asarray(b)
    assert onp.abs(a - b).max() <= tol * max(onp.abs(b).max(), 1.0)


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="tanh"),
            pkg.gluon.nn.Dense(5))
    return net


def _convnet(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Flatten(),
            nn.Dense(3))
    return net


def _pair(build, x):
    """The reference ``build(mx)`` settled on ``x``, and the port's with
    its weights; both hybridized."""
    mx.random.seed(3)
    ref = build(mx)
    ref.initialize(mx.init.Xavier())
    ref(mx.nd.array(x))
    net = build(tmx)
    net.initialize()
    net(tmx.nd.array(x))
    load_numpy_params(net, _params(ref))
    ref.hybridize()
    net.hybridize()
    return ref, net


def _recorded(pkg, net, x, y):
    """One recorded forward and backward of a squared-error loss, the
    input's gradient attached: (outputs, {name: gradient}, the input's
    gradient under ``"x"``)."""
    xa = pkg.nd.array(x)
    xa.attach_grad()
    with pkg.autograd.record():
        out = net(xa)
        loss = ((out - pkg.nd.array(y)) ** 2).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in
             net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    grads["x"] = xa.grad.asnumpy()
    return out.asnumpy(), grads


@pytest.mark.parametrize("build,shape", [(_mlp, (6, 10)),
                                         (_convnet, (4, 2, 6, 6))],
                         ids=["mlp", "convnet"])
def test_outputs_and_gradients_match_reference(build, shape):
    x = _rand(0, *shape)
    ref, net = _pair(build, x)
    y = _rand(1, shape[0], 5 if build is _mlp else 3)
    want_out, want = _recorded(mx, ref, x, y)
    got_out, got = _recorded(tmx, net, x, y)
    _close(got_out, want_out)
    for k, g in want.items():
        _close(got[k], g)
    # predict mode: another signature, as in the reference
    _close(net(tmx.nd.array(x)), ref(mx.nd.array(x)))
    assert len(net._cached_op._jit_cache) == \
        len(ref._cached_op._jit_cache) == 2


def test_batchnorm_statistics_after_three_recorded_steps():
    x0 = _rand(2, 4, 2, 6, 6)
    ref, net = _pair(_convnet, x0)
    for step in range(3):
        x = _rand(10 + step, 4, 2, 6, 6) * (1 + step)
        y = _rand(20 + step, 4, 3)
        _recorded(mx, ref, x, y)
        _recorded(tmx, net, x, y)
    got, want = _params(net), _params(ref)
    for k in ("1.running_mean", "1.running_var"):
        _close(got[k], want[k])
    assert not onp.allclose(got["1.running_mean"], 0)
    assert len(net._cached_op._jit_cache) == 1


def test_moe_gpt2_aux_losses_reach_the_loss():
    """A 2-layer routed GPT-2, hybridized in both packages: the routers'
    aux losses leave the compiled call and reach the loss, which
    differs from the logits' cross entropy alone; logits, loss and
    every gradient agree."""
    rs = onp.random.RandomState(4)
    toks = rs.randint(0, 128, (4, 16)).astype("int32")
    labels = rs.randint(0, 128, (4, 16)).astype("int32")
    jn = jget_gpt2("gpt2_124m", **MOE_CFG)
    mx.random.seed(5)
    jn.initialize()
    net = load_numpy_params(tget_gpt2("gpt2_124m", **MOE_CFG),
                            _params(jn))
    jn.hybridize()
    net.hybridize()
    runs = {}
    for pkg, m, lossf in ((mx, jn, jloss), (tmx, net, tloss)):
        with pkg.autograd.record():
            logits = m(pkg.nd.array(toks, dtype="int32"))
            loss = lossf(logits, pkg.nd.array(labels, dtype="int32"))
        loss.backward()
        runs[pkg] = (logits.asnumpy(), float(loss.asnumpy()),
                     {k: p.grad().asnumpy() for k, p in
                      m._collect_params_with_prefix().items()})
    (jl, jv, jg), (tl, tv, tg) = runs[mx], runs[tmx]
    _close(tl, jl)
    assert tv == pytest.approx(jv, rel=TOL)
    plain = float(tloss(torch.from_numpy(tl), torch.from_numpy(labels)))
    assert abs(tv - plain) > 1e-4          # the aux term is in
    assert "h1.moe.w1" in tg
    top = max(float(onp.abs(g).max()) for g in jg.values())
    for k, g in jg.items():
        # k_proj.bias only shifts a row's scores: zero but for rounding
        scale = top if k.endswith("k_proj.bias") else \
            float(onp.abs(g).max())
        assert float(onp.abs(tg[k] - g).max()) <= MOE_GRAD_TOL * scale, k
    assert tmx.base.pop_aux_losses() == []
    assert len(net._cached_op._jit_cache) == len(jn._cached_op._jit_cache)


def test_deferred_initialization_retry():
    """Hybridized before its first call, with every shape deferred: the
    CachedOp finds the parameters waiting, one imperative call settles
    them, and the retry compiles; the reference counts one signature
    too."""
    x = _rand(5, 3, 10)
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    out = net(tmx.nd.array(x))
    assert net[0].weight.shape == (16, 10) and out.shape == (3, 5)
    ref = _mlp(mx)
    ref.initialize()
    ref.hybridize()
    ref(mx.nd.array(x))
    assert len(net._cached_op._jit_cache) == \
        len(ref._cached_op._jit_cache) == 1
    load_numpy_params(net, _params(ref))
    _close(net(tmx.nd.array(x)), ref(mx.nd.array(x)))


class _Scaled:
    """A block with a static argument, in either package."""

    @staticmethod
    def build(pkg):
        class Scaled(pkg.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.dense = pkg.gluon.nn.Dense(4, in_units=3)

            def forward(self, x, scale, shift=None):
                y = self.dense(x) * scale
                return y if shift is None else y + shift
        return Scaled()


def test_static_arguments_key_the_cache():
    ref, net = _Scaled.build(mx), _Scaled.build(tmx)
    ref.initialize()
    net.initialize()
    load_numpy_params(net, _params(ref))
    ref.hybridize()
    net.hybridize()
    x = _rand(6, 2, 3)
    for scale in (1.0, 2.0, 1.0, 3.0):
        _close(net(tmx.nd.array(x), scale), ref(mx.nd.array(x), scale))
        assert len(net._cached_op._jit_cache) == \
            len(ref._cached_op._jit_cache)
    assert len(net._cached_op._jit_cache) == 3
    # an array argument in a static position's place is an input
    shift = _rand(7, 4)
    _close(net(tmx.nd.array(x), 2.0, tmx.nd.array(shift)),
           ref(mx.nd.array(x), 2.0, mx.nd.array(shift)))


def test_train_predict_switching_counts_signatures_like_reference():
    """The same sequence of calls in both packages — predict, record,
    predict again, another batch size, train mode without recording —
    leaves the same number of compiled signatures after each call."""
    x = _rand(8, 4, 10)
    ref, net = _pair(_mlp, x)
    calls = [("predict", 4), ("record", 4), ("predict", 4), ("record", 4),
             ("predict", 2), ("train", 2), ("record", 2)]
    for mode, b in calls:
        for pkg, m in ((mx, ref), (tmx, net)):
            xa = pkg.nd.array(x[:b])
            if mode == "record":
                with pkg.autograd.record():
                    out = m(xa)
                out.backward()
            elif mode == "train":
                with pkg.autograd.train_mode():
                    out = m(xa)
            else:
                out = m(xa)
            if pkg is mx:
                want = out.asnumpy()
        _close(out, want)
        assert len(net._cached_op._jit_cache) == \
            len(ref._cached_op._jit_cache), (mode, b)
    assert len(net._cached_op._jit_cache) == 4
    net.hybridize(False)
    assert net._cached_op is None
    _close(net(tmx.nd.array(x)), ref(mx.nd.array(x)))


def test_tensor_convention_and_outstanding_recorded_calls():
    """Tensors in, tensors out (grad mode is torch's).  A recorded call
    whose backward has not run holds its program's activations; a second
    recorded call of the same signature meanwhile gets a program of its
    own, and each backward gives its own call's gradients."""
    x = _rand(9, 4, 10)
    _ref, net = _pair(_mlp, x)
    xt = torch.from_numpy(x)
    x2 = torch.from_numpy(_rand(19, 4, 10))
    out = net(xt)
    assert isinstance(out, torch.Tensor) and out.requires_grad
    out2 = net(x2)
    entry = next(iter(net._cached_op._jit_cache.values()))
    assert [len(p) for p in entry._train.values()] == [2]
    grads = []
    for o in (out2, out):
        net.zero_grad()
        (o ** 2).sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    again = net(xt)
    assert torch.equal(again, out)
    assert [len(p) for p in entry._train.values()] == [2]
    net.hybridize(False)
    for xi, want in ((x2, grads[0]), (xt, grads[1])):
        net.zero_grad()
        (net(xi) ** 2).sum().backward()
        for p, g in zip(net.parameters(), want):
            assert torch.equal(p.grad, g)
    net.hybridize()
    with torch.no_grad():
        assert not net(xt).requires_grad


@pytest.mark.parametrize("mode", ["predict", "record"])
def test_collected_outputs_stay_each_calls_own(mode):
    """``preds = [net(x) for x in batches]``: every collected output is
    its own batch's, as the reference's and the eager block's."""
    x0 = _rand(30, 4, 10)
    ref, net = _pair(_mlp, x0)
    batches = [_rand(31 + i, 4, 10) for i in range(3)]
    got, want = [], []
    for x in batches:
        if mode == "record":
            with tmx.autograd.record():
                got.append(net(tmx.nd.array(x)))
        else:
            got.append(net(tmx.nd.array(x)))
        want.append(ref(mx.nd.array(x)))
    for g, w in zip(got, want):
        _close(g, w)
    assert not onp.allclose(got[0].asnumpy(), got[-1].asnumpy())


def test_gan_step_calls_the_discriminator_twice_under_one_record():
    """Gluon's DCGAN discriminator step: the hybridized ``netD`` on real
    data and on the generator's detached output inside one ``record()``
    (one signature, two outstanding calls), one ``backward``; then the
    generator's step through ``netD`` again.  Losses and every gradient
    against the reference's."""
    z = _rand(40, 4, 6)
    real = _rand(41, 4, 10)

    def make_g(pkg):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(10, activation="tanh"))
        return net
    ref_d, net_d = _pair(_mlp, real)
    ref_g, net_g = _pair(make_g, z)
    runs = {}
    for pkg, g, d in ((mx, ref_g, ref_d), (tmx, net_g, net_d)):
        with pkg.autograd.record():
            err_real = (d(pkg.nd.array(real)) ** 2).mean()
            fake = g(pkg.nd.array(z))
            err_fake = ((d(fake.detach()) - 1) ** 2).mean()
            err_d = err_real + err_fake
        err_d.backward()
        d_grads = {k: p.grad().asnumpy() for k, p in
                   d._collect_params_with_prefix().items()}
        with pkg.autograd.record():
            err_g = (d(fake) ** 2).mean()
        err_g.backward()
        g_grads = {k: p.grad().asnumpy() for k, p in
                   g._collect_params_with_prefix().items()}
        runs[pkg] = (float(err_d.asnumpy()), float(err_g.asnumpy()),
                     d_grads, g_grads)
    (jd, jg, jdg, jgg), (td, tg, tdg, tgg) = runs[mx], runs[tmx]
    assert td == pytest.approx(jd, rel=TOL)
    assert tg == pytest.approx(jg, rel=TOL)
    for got, want in ((tdg, jdg), (tgg, jgg)):
        for k, w in want.items():
            _close(got[k], w)
    assert len(net_d._cached_op._jit_cache) == \
        len(ref_d._cached_op._jit_cache)


def test_hybridized_block_runs_inline_in_a_serving_program():
    """A hybridized block served in forward mode runs inline in the
    engine's program (on the CPU as in the card's capture): no CachedOp
    program of its own, and the outputs of its direct forward."""
    from mxnet_tpu_torch.serving import InferenceEngine
    net = _mlp(tmx)
    net.initialize(device="cpu", seed=0)
    xs = _rand(42, 3, 10)
    with torch.no_grad():
        want = net(torch.from_numpy(xs))
    net.hybridize()
    eng = InferenceEngine(net, max_batch=4, device="cpu")
    assert eng.mode == "forward" and eng.warmup(example_shape=(10,)) == 3
    futs = [eng.submit(x) for x in xs]
    with eng:
        outs = [f.result(timeout=60) for f in futs]
    for o, w in zip(outs, want):
        onp.testing.assert_allclose(o, w.numpy(), rtol=1e-6, atol=1e-6)
    assert net._cached_op is None
