"""``ShardedTrainer``'s step as one program per batch signature, and the
optimizers' updates with device scalars, against the JAX package.

On the CPU a program runs the step's function on its static buffers
(the batch, and ``lr`` and ``t`` as float32 and int32 0-d tensors, as
the reference traces them); the card replays it as one CUDA graph
(``test_torch_cuda.py`` holds the replays to these steps).  A tiny GPT-2
(``test_torch_train.py``'s) trains in both packages from one set of
weights.  Tolerances are ``test_torch_train.py``'s: losses relative
1e-5, parameters max-abs 1e-4 after Adam steps; the optimizers'
updates ``test_torch_optimizers.py``'s (rtol 1e-5, atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import parallel as par
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.models import gpt2_lm_loss as jloss
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.utils.convert import load_numpy_params

CFG = dict(vocab_size=64, units=32, num_layers=2, num_heads=2,
           max_length=32, dropout=0.0)
B, T = 4, 16
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4
RTOL, ATOL = 1e-5, 1e-6

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(0)
    jn.initialize()
    return {k: p.data().asnumpy()
            for k, p in jn._collect_params_with_prefix().items()}


def _batch(seed, b=B):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, 64, (b, T)).astype("int32"),
            rs.randint(0, 64, (b, T)).astype("int32"))


def _pair(params, opt_params, loss=(jloss, tloss), **kw):
    """The reference trainer over a one-device mesh and the port's, from
    the same weights."""
    mesh = par.make_mesh(dp=1, devices=jax.devices()[:1])
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(0)
    jn.initialize()
    for k, p in jn._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    with par.use_mesh(mesh):
        jtr = par.ShardedTrainer(jn, "adam", loss=loss[0], mesh=mesh,
                                 optimizer_params=opt_params(jlrs), **kw)
    net = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                            params)
    ttr = ShardedTrainer(net, "adam", loss=loss[1],
                         optimizer_params=opt_params(tlrs), **kw)
    return mesh, jtr, ttr


def _ref_step(mesh, tr, data, *labels):
    with par.use_mesh(mesh):
        out = tr.step(mx.nd.array(data, dtype="int32"),
                      tuple(mx.nd.array(x) for x in labels))
    if isinstance(out, tuple):
        return float(out[0].asnumpy()), bool(out[1].asnumpy())
    return float(out.asnumpy())


def _port_step(tr, data, *labels):
    out = tr.step(data, labels)
    if isinstance(out, tuple):
        return float(out[0]), bool(out[1])
    return float(out)


def _params_close(jtr, ttr):
    want = {k: p.data().asnumpy()
            for k, p in jtr.net._collect_params_with_prefix().items()}
    for k, p in ttr.net.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(), want[k],
                                    atol=PARAM_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["scheduler", "set_learning_rate",
                                  "grad_accum", "hybridized"])
def test_program_matches_reference(params, case):
    """Five steps of one program: under a warm-up-and-factor scheduler
    (the learning rate moves every step), with ``set_learning_rate``
    between steps 2 and 3, over 2 microbatches, or of a hybridized net
    (inside the step's program it runs inline, on the CPU as in the
    card's capture: no CachedOp of its own is built).  Losses and the
    final parameters agree; one program served every step."""
    kw = {"grad_accum": 2} if case == "grad_accum" else {}

    def opt_params(lrs):
        if case != "scheduler":
            return {"learning_rate": 1e-3}
        return {"learning_rate": 3e-3, "lr_scheduler": lrs.FactorScheduler(
            step=2, factor=0.5, warmup_steps=2, warmup_begin_lr=1e-4)}
    mesh, jtr, ttr = _pair(params, opt_params, **kw)
    if case == "hybridized":
        ttr.net.hybridize()
    for step in range(5):
        if case == "set_learning_rate" and step == 2:
            jtr.set_learning_rate(3e-3)
            ttr.set_learning_rate(3e-3)
        toks, labels = _batch(step)
        assert _port_step(ttr, toks, labels) == pytest.approx(
            _ref_step(mesh, jtr, toks, labels), rel=LOSS_RTOL)
    assert len(ttr._programs) == 1
    assert ttr.optimizer.num_update == 5
    if case == "hybridized":
        assert ttr.net._active and ttr.net._cached_op is None
    _params_close(jtr, ttr)


def test_guarded_nonfinite_replay_leaves_state_bit_identical(params):
    """A loss-scaled program whose second step is NaN: parameters and
    Adam state stay bit for bit, the scale halves, the count of finite
    steps restarts, and the third step updates again, as the
    reference's."""
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch import amp as tamp

    def poisoned(lm):
        return lambda out, labels, poison: lm(out, labels) + poison.sum()
    mesh = par.make_mesh(dp=1, devices=jax.devices()[:1])
    _m, jtr, ttr = _pair(params, lambda _l: {"learning_rate": 1e-3},
                         loss=(poisoned(jloss), poisoned(tloss)))
    jtr = par.ShardedTrainer(
        jtr.net, "adam", loss=poisoned(jloss), mesh=mesh,
        optimizer_params={"learning_rate": 1e-3},
        loss_scaler=jamp.LossScaler(16.0, 2.0, 4))
    ttr = ShardedTrainer(ttr.net, "adam", loss=poisoned(tloss),
                         optimizer_params={"learning_rate": 1e-3},
                         loss_scaler=tamp.LossScaler(16.0, 2.0, 4))
    nan, ok = onp.full(B, onp.nan, "float32"), onp.zeros(B, "float32")
    for step, poison in enumerate([ok, nan, ok]):
        toks, labels = _batch(10 + step)
        before = {k: v.clone() for k, v in ttr.state_dict().items()} \
            if step else {}
        loss, finite = _port_step(ttr, toks, labels, poison)
        want = _ref_step(mesh, jtr, toks, labels, poison)
        assert finite == want[1] == (step != 1)
        assert ttr.loss_scale == jtr.loss_scale
        if finite:
            assert loss == pytest.approx(want[0], rel=LOSS_RTOL)
        else:
            after = ttr.state_dict()
            for k, v in before.items():
                if not k.startswith("meta:"):
                    assert torch.equal(after[k], v), k
            assert ttr.loss_scale == 8.0
            assert int(after["meta:good_steps"][0]) == 0
    assert len(ttr._programs) == 1
    _params_close(jtr, ttr)


def test_second_batch_shape_makes_a_second_program(params):
    """The last short batch captures another program (jax retraces);
    going back to the first shape replays the first."""
    mesh, jtr, ttr = _pair(params, lambda _l: {"learning_rate": 1e-3})
    for step, b in enumerate((B, B, 2, B)):
        toks, labels = _batch(20 + step, b)
        assert _port_step(ttr, toks, labels) == pytest.approx(
            _ref_step(mesh, jtr, toks, labels), rel=LOSS_RTOL)
    assert sorted(k[0][0] for k in ttr._programs) == [(2, T), (B, T)]
    _params_close(jtr, ttr)


# the optimizers whose update reads the learning rate or the count
READS_LR_OR_T = [("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
                 ("adam", {}), ("adamw", {}), ("rmsprop", {}),
                 ("rmsprop", {"centered": True}), ("adagrad", {}),
                 ("adamax", {}), ("ftrl", {}), ("lamb", {}), ("lars", {}),
                 ("signum", {"wd_lh": 0.01}), ("dcasgd", {})]
SHAPES = [(4, 3), (5,), (3,)]


@pytest.mark.parametrize("name,kw", READS_LR_OR_T, ids=[
    n + ("-centered" if k.get("centered") else "") for n, k in
    READS_LR_OR_T])
def test_device_scalar_updates_match_reference(name, kw):
    """Three list-wise updates under ``traced`` with ``lr`` and ``t`` as
    0-d tensors (float32, int32) against the reference's traced update
    with jax scalars of the same types; the last weight is all zeros
    (the trust-ratio guards)."""
    rs = onp.random.RandomState(len(name))
    ws = [rs.randn(*s).astype("float32") for s in SHAPES]
    ws[-1][:] = 0
    gss = [[rs.randn(*s).astype("float32") * 3 for s in SHAPES]
           for _ in range(3)]
    common = dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5, **kw)
    jo, to = jopt.create(name, **common), topt.create(name, **common)
    jw = [mx.nd.array(x) for x in ws]
    tw = [torch.from_numpy(x.copy()) for x in ws]
    jst = [jo.create_state_multi_precision(i, x) for i, x in enumerate(jw)]
    tst = [to.create_state_multi_precision(i, x) for i, x in enumerate(tw)]
    idx = list(range(len(ws)))
    for t, gs in enumerate(gss, 1):
        with jo.traced(jnp.float32(0.01), jnp.int32(t)):
            for i, g in enumerate(gs):
                jo.update_multi_precision(i, jw[i], mx.nd.array(g), jst[i])
        with to.traced(torch.tensor(0.01), torch.tensor(t,
                                                        dtype=torch.int32)):
            to.update_multi(idx, tw, [torch.from_numpy(g) for g in gs], tst)
    for i in idx:
        onp.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(),
                                    rtol=RTOL, atol=ATOL)
