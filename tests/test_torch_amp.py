"""The port's amp cast policy against the JAX package's.

The reference's own amp cases (``tests/test_amp_profiler_image.py``),
the Gluon-trainer cases of ``tests/test_guardrails.py`` (loss scaling,
``unscale``, the skipped overflowed step, the one-time warning), and a
small GPT-2 (2 layers, 256 units, 4 heads of 64, T 256: the shapes the
flash route takes on the card) under both packages' ``amp.init()``: the
same op names get the same dtypes at every named point, and logits,
loss and step-1 gradients agree within 2e-2 of their max-abs (bf16
keeps 8 bits of mantissa, 3.9e-3 of a value, and the two packages
round the same products in another order).  The plain versions of B1,
B2 and B3 take bf16 inputs at that attention shape against the Pallas
kernels in interpret mode, at the reference tests' bf16 tolerance
(1e-2 of the max-abs).  Every test leaves amp off in both packages.
"""
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import parallel as par
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.models import gpt2_lm_loss as jloss
from mxnet_tpu.ops import flash as jflash
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.ops import flash as tflash
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.utils.convert import load_numpy_params

# one intra-op thread per test process (see test_torch_gluon_core.py)
torch.set_num_threads(1)

BF16_TOL = 2e-2
KERNEL_TOL = 1e-2
CFG = dict(vocab_size=256, units=256, num_layers=2, num_heads=4,
           max_length=256, dropout=0.0)
B, T = 2, 256


@pytest.fixture(autouse=True)
def amp_off():
    with tmx.cpu():
        yield
    jamp.reset()
    tamp.reset()


def _dt(x):
    """The dtype name of an NDArray (either package) or a tensor."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[1]
    return str(x.dtype)


def _rel(got, want):
    got, want = onp.asarray(got, "float32"), onp.asarray(want, "float32")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


# ------------------------------------- tests/test_amp_profiler_image.py

def test_amp_policy_casts_matmul():
    rs0, rs1 = onp.random.RandomState(0), onp.random.RandomState(1)
    a, b = rs0.randn(8, 8).astype("float32"), rs1.randn(8, 8).astype("float32")
    jamp.init(target_dtype="bfloat16")
    tamp.init(target_dtype="bfloat16")
    for pkg in (mx, tmx):
        out = pkg.nd.dot(pkg.nd.array(a), pkg.nd.array(b))
        assert _dt(out) == "bfloat16"
        sm = pkg.nd.softmax(out, axis=-1)
        assert _dt(sm) == "float32"
    want = mx.nd.dot(mx.nd.array(a), mx.nd.array(b)).astype("float32")
    got = tmx.nd.dot(tmx.nd.array(a), tmx.nd.array(b)).astype("float32")
    assert _rel(got.asnumpy(), want.asnumpy()) <= BF16_TOL
    # an op on neither list keeps its input dtype; mixed inputs widen
    x = tmx.nd.array(a).astype("bfloat16")
    assert _dt(tmx.nd.relu(x)) == "bfloat16"
    assert _dt(x + tmx.nd.array(b)) == "float32"
    assert tamp.current_policy().target_dtype == torch.bfloat16
    assert tamp.init("float16").target_dtype == torch.float16
    assert _dt(tmx.nd.dot(tmx.nd.array(a), tmx.nd.array(b))) == "float16"


def test_amp_off_no_cast():
    for pkg in (mx, tmx):
        a = pkg.nd.array(onp.ones((4, 4), "float32"))
        assert _dt(pkg.nd.dot(a, a)) == "float32"
    assert tamp.current_policy() is None
    x = torch.ones(2, 3)
    out = tamp.cast("FullyConnected", x, None)
    assert out[0] is x and out[1] is None


def test_amp_policy_is_thread_local():
    """As in the reference, ``amp.init`` covers the calling thread only
    (a serving engine's scheduler thread keeps its own)."""
    tamp.init()
    seen = {}

    def other():
        seen["policy"] = tamp.current_policy()
        a = tmx.nd.array(onp.ones((2, 2), "float32"), ctx=tmx.cpu())
        seen["dtype"] = _dt(tmx.nd.dot(a, a))

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert seen == {"policy": None, "dtype": "float32"}
    assert tamp.current_policy() is not None


def _mlp_losses(pkg, params, steps=15):
    """The reference's amp training case: Dense(16, relu), Dense(2),
    Xavier, SGD 0.1, SoftmaxCE, under ``amp.init()``."""
    pkg.amp.init()
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu"), pkg.gluon.nn.Dense(2))
    net.initialize(pkg.init.Xavier())
    structural = (net._collect_params_with_prefix() if pkg is mx
                  else net.collect_params())
    for k, p in structural.items():
        p.set_data(pkg.nd.array(params[k]))
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    rs = onp.random.RandomState(0)
    X = pkg.nd.array(rs.randn(32, 8).astype("float32"))
    y = pkg.nd.array((rs.rand(32) > 0.5).astype("float32"))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            out = net(X)
            loss = loss_fn(out, y)
        assert _dt(out) == "bfloat16" and _dt(loss) == "float32"
        loss.backward()
        trainer.step(32)
        losses.append(float(loss.asnumpy().mean()))
    for _, p in structural.items():
        assert _dt(p.data()) == "float32"
        assert pkg is mx or _dt(p.grad()) == "float32"
    return losses, {k: p.data().asnumpy() for k, p in structural.items()}


def test_amp_end_to_end_training():
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu"), mx.gluon.nn.Dense(2))
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1, 8)))
    params = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    want, want_params = _mlp_losses(mx, params)
    got, got_params = _mlp_losses(tmx, params)
    assert got[-1] < got[0]
    assert abs(got[0] - want[0]) / want[0] <= BF16_TOL
    for k in want_params:
        assert _rel(got_params[k], want_params[k]) <= BF16_TOL, k


def test_amp_convert_model():
    for pkg in (mx, tmx):
        net = pkg.gluon.nn.Dense(4, in_units=8)
        net.initialize()
        pkg.amp.convert_model(net, "bfloat16")
        structural = (net._collect_params_with_prefix() if pkg is mx
                      else net.collect_params())
        assert _dt(structural["weight"].data()) == "bfloat16"
        assert _dt(structural["bias"].data()) == "bfloat16"
    ln = tnn.HybridSequential()
    ln.add(tnn.Dense(4, in_units=4), tnn.LayerNorm(in_channels=4))
    ln.initialize()
    tamp.convert_hybrid_block(ln, "bfloat16")
    assert [_dt(p.data()) for p in ln.collect_params().values()] == \
        ["bfloat16", "bfloat16", "float32", "float32"]


def test_amp_cast_and_multicast():
    x = onp.arange(4, dtype="float32")
    for pkg in (mx, tmx):
        assert _dt(pkg.amp.amp_cast(pkg.nd.array(x))) == "bfloat16"
        a, b = pkg.amp.amp_multicast(pkg.nd.array(x).astype("bfloat16"),
                                     pkg.nd.array(x))
        assert _dt(a) == _dt(b) == "float32"
    assert tamp.amp_cast(torch.ones(2), "float16").dtype == torch.float16


# --------------------------------------------- tests/test_guardrails.py

def _scaled_dense(scale=1024.0):
    net = tnn.Dense(2, in_units=4)
    net.initialize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    tamp.init_trainer(trainer, loss_scaler=tamp.LossScaler(
        init_scale=scale, scale_factor=2.0, scale_window=2000))
    rs = onp.random.RandomState(0)
    X = tmx.nd.array(rs.randn(8, 4).astype("float32"))
    y = tmx.nd.array((onp.arange(8) % 2).astype("float32"))
    return net, trainer, X, y


def _scaled_backward(net, trainer, X, y):
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        with tamp.scale_loss(loss_fn(net(X), y), trainer) as scaled:
            scaled.backward()


def test_unscale_divides_grads_once():
    """``unscale`` divides the gradients by the scale before ``step``,
    which then does not divide again: the update equals an unscaled
    step's."""
    net, trainer, X, y = _scaled_dense()
    w = net.collect_params()["weight"]
    start = w.data().asnumpy().copy()
    _scaled_backward(net, trainer, X, y)
    scaled_grad = w.grad().asnumpy().copy()
    tamp.unscale(trainer)
    onp.testing.assert_allclose(w.grad().asnumpy(), scaled_grad / 1024.0,
                                rtol=1e-6)
    trainer.step(8)
    after = w.data().asnumpy()
    plain, ptrainer, _, _ = _scaled_dense()
    plain.collect_params()["weight"].set_data(start)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss_fn(plain(X), y).backward()
    tmx.gluon.Trainer(plain.collect_params(), "sgd",
                      {"learning_rate": 0.1}).step(8)
    onp.testing.assert_allclose(
        after, plain.collect_params()["weight"].data().asnumpy(), rtol=1e-5,
        atol=1e-7)


def test_amp_gluon_trainer_skips_overflowed_step():
    net, trainer, X, y = _scaled_dense()
    _scaled_backward(net, trainer, X, y)
    w = net.collect_params()["weight"]
    before = w.data().asnumpy().copy()
    g = w.grad()
    g *= float("nan")
    trainer.step(8)
    onp.testing.assert_array_equal(w.data().asnumpy(), before)
    assert trainer._amp_loss_scaler.loss_scale == 512.0
    assert trainer.skipped_steps == 1
    _scaled_backward(net, trainer, X, y)
    trainer.step(8)
    assert not onp.array_equal(w.data().asnumpy(), before)


def test_amp_no_scaler_warns_once():
    net = tnn.Dense(2, in_units=4)
    net.initialize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd")
    tamp._warned_no_scaler = False
    with pytest.warns(FutureWarning, match="no LossScaler"):
        with tamp.scale_loss(tmx.nd.array([2.0]), trainer) as l:
            assert float(l.asnumpy()[0]) == 2.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")         # second call: silent
        with tamp.scale_loss(tmx.nd.array([2.0]), trainer):
            pass
        tamp.unscale(trainer)


# ------------------------------------------------- GPT-2 under amp.init()

def _batch(seed):
    rs = onp.random.RandomState(seed)
    return tuple(rs.randint(0, CFG["vocab_size"], (B, T)).astype("int32")
                 for _ in range(2))


@pytest.fixture(scope="module")
def gpt_params():
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(0)
    jn.initialize()
    return {k: p.data().asnumpy()
            for k, p in jn._collect_params_with_prefix().items()}


def _ref_gpt(params):
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(0)
    jn.initialize()
    for k, p in jn._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    return jn


def _port_gpt(params):
    return load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                             params)


def _watch(net):
    """Forward hooks recording the dtype at the named points of layer 0
    and of the model: q (and k, v), attention out, FFN hidden, the
    residual stream after the layer, and the logits."""
    seen = {}
    blk = net.blocks[0]

    def out_hook(key):
        return lambda b, args, out: seen.__setitem__(key, _dt(out))

    for name in ("q_proj", "k_proj", "v_proj"):
        getattr(blk.attn, name).register_forward_hook(out_hook(name))
    blk.attn.out_proj.register_forward_pre_hook(
        lambda b, args: seen.__setitem__("attention out", _dt(args[0])))
    blk.ffn.fc1.register_forward_hook(out_hook("ffn hidden"))
    blk.ffn.act.register_forward_hook(out_hook("gelu out"))
    blk.register_forward_hook(out_hook("residual stream"))
    net.ln_f.register_forward_hook(out_hook("ln_f out"))
    return seen


def _ref_forward(params, toks, labels):
    jamp.init()
    jn = _ref_gpt(params)
    seen = _watch(jn)
    x = mx.nd.array(toks, dtype="int32")
    with mx.autograd.record():
        logits = jn(x)
        loss = jloss(logits, mx.nd.array(labels, dtype="int32"))
    loss.backward()
    seen["logits"], seen["loss"] = _dt(logits), _dt(loss)
    grads = {k: p.grad().asnumpy().astype("float32")
             for k, p in jn._collect_params_with_prefix().items()}
    return seen, logits.astype("float32").asnumpy(), float(
        loss.asnumpy()), grads


def _port_forward(params, toks, labels):
    tamp.init()
    tn = _port_gpt(params)
    seen = _watch(tn)
    x = tmx.nd.array(toks, dtype="int32")
    with tmx.autograd.record():
        logits = tn(x)
        loss = tloss(logits, tmx.nd.array(labels, dtype="int32"))
    loss.backward()
    seen["logits"], seen["loss"] = _dt(logits), _dt(loss)
    grads = {k: p.grad().asnumpy() for k, p in tn.collect_params().items()}
    for p in tn.collect_params().values():
        assert _dt(p.data()) == _dt(p.grad()) == "float32"
    return seen, logits.astype("float32").asnumpy(), float(
        loss.asnumpy()), grads


def test_gpt2_amp_dtypes_logits_loss_and_grads_match(gpt_params):
    toks, labels = _batch(0)
    want = _ref_forward(gpt_params, toks, labels)
    got = _port_forward(gpt_params, toks, labels)
    assert got[0] == want[0]
    assert got[0]["q_proj"] == got[0]["attention out"] == "bfloat16"
    assert got[0]["ffn hidden"] == got[0]["logits"] == "bfloat16"
    assert got[0]["residual stream"] == got[0]["loss"] == "float32"
    assert _rel(got[1], want[1]) <= BF16_TOL
    assert abs(got[2] - want[2]) / abs(want[2]) <= BF16_TOL
    assert sorted(got[3]) == sorted(want[3])
    # k_proj.bias's gradient is zero in exact arithmetic (the softmax
    # cancels it): both sides return bf16 rounding noise, held against
    # the largest gradient of the model instead of its own
    top = max(abs(g).max() for g in want[3].values())
    for k, g in want[3].items():
        scale = top if k.endswith("k_proj.bias") else abs(g).max()
        assert abs(got[3][k] - g).max() <= BF16_TOL * scale, k


def _gluon_losses(pkg, net, steps):
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for step in range(steps):
        toks, labels = _batch(step)
        x = pkg.nd.array(toks, dtype="int32")
        with pkg.autograd.record():
            logits = net(x)
            loss = loss_fn(logits, pkg.nd.array(labels, dtype="int32"))
        assert _dt(logits) == "bfloat16" and _dt(loss) == "float32"
        loss.backward()
        trainer.step(B)
        losses.append(float(loss.mean().asscalar()))
    return losses


def test_gpt2_amp_gluon_loop_and_sharded_trainer(gpt_params):
    """Two Gluon-loop steps (SoftmaxCE, Adam) under amp in both
    packages, and one ``ShardedTrainer`` step under amp against the
    reference's on a one-device mesh."""
    jamp.init()
    want = _gluon_losses(mx, _ref_gpt(gpt_params), 2)
    tamp.init()
    tn = _port_gpt(gpt_params)
    got = _gluon_losses(tmx, tn, 2)
    for g, w in zip(got, want):
        assert abs(g - w) / abs(w) <= BF16_TOL
    for p in tn.collect_params().values():
        assert _dt(p.data()) == "float32"

    toks, labels = _batch(5)
    mesh = par.make_mesh(dp=1, devices=jax.devices()[:1])
    jn = _ref_gpt(gpt_params)
    with par.use_mesh(mesh):
        jt = par.ShardedTrainer(jn, "adam", loss=jloss, mesh=mesh,
                                optimizer_params={"learning_rate": 1e-3})
        jl = float(jt.step(mx.nd.array(toks, dtype="int32"),
                           (mx.nd.array(labels),)).asnumpy())
    st = ShardedTrainer(_port_gpt(gpt_params), "adam", loss=tloss,
                        optimizer_params={"learning_rate": 1e-3})
    tl = float(st.step(toks, labels))
    assert abs(tl - jl) / abs(jl) <= BF16_TOL
    for p in st.net.parameters():
        assert p.dtype == torch.float32


def test_flash_plain_versions_in_bf16_match_pallas():
    """B1 forward and B2/B3 gradients, plain versions on bf16 inputs at
    the amp GPT-2's attention shape, against the Pallas kernels in
    interpret mode on the same bf16 values."""
    rs = onp.random.RandomState(3)
    q, k, v, cot = (rs.randn(1, T, 2, 64).astype("float32")
                    for _ in range(4))
    c = jnp.asarray(cot, jnp.bfloat16)

    def f(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, causal=True,
                                     interpret=True)
        return jnp.sum((out * c).astype(jnp.float32)), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    xs = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
          for x in (q, k, v)]
    out = tflash.flash_attention(*xs, causal=True)
    assert out.dtype == torch.bfloat16
    loss = (out * torch.from_numpy(cot).to(torch.bfloat16)).float().sum()
    grads = torch.autograd.grad(loss, xs)
    assert _rel(out.detach().float().numpy(),
                onp.asarray(ref_out.astype(jnp.float32))) <= KERNEL_TOL
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(),
                    onp.asarray(r.astype(jnp.float32))) <= KERNEL_TOL
