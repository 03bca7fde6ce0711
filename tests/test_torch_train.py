"""The port's training slice against the JAX package's.

A tiny GPT-2 (vocab 512, 128 units, 2 layers, 2 heads of 64, 256
positions, dropout 0) is built in both packages with the reference's
weights copied into the port (``load_numpy_params``).  The reference
trains with ``par.ShardedTrainer`` over a one-device mesh, the port with
its ``ShardedTrainer`` on ``device="cpu"``; both take Adam steps on the
same numpy batches.

Tolerances: losses relative 1e-5 and step-1 gradients max-abs 1e-5 (the
same float32 math, summed in another order by XLA and by torch);
parameters max-abs 1e-4 after Adam steps at lr 1e-3, whose normalized
update ``m / sqrt(v)`` turns a gradient's rounding into at most a few
lr-sized steps of difference only where the gradient is near zero.
"""
import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import parallel as par
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.models import gpt2_lm_loss as jloss
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError, training_mode
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.utils.convert import load_numpy_params, load_numpy_state

CFG = dict(vocab_size=512, units=128, num_layers=2, num_heads=2,
           max_length=256, dropout=0.0)
B, T = 4, 32
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-4
# the reference weights' seed: the same weights whatever ran before
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


def _port_net(params, **cfg):
    return load_numpy_params(
        tget_gpt2("gpt2_124m", device="cpu", **dict(CFG, **cfg)), params)


def _poisoned_loss(lm_loss):
    """LM loss plus the sum of a (B,) "poison" label: zeros keep the
    step, a NaN makes its loss (and so every gradient) non-finite."""
    def loss(out, labels, poison):
        return lm_loss(out, labels) + poison.sum()
    return loss


class _Ref:
    """The reference trainer over a one-device mesh."""

    def __init__(self, params, loss=jloss, **kw):
        self.mesh = par.make_mesh(dp=1, devices=jax.devices()[:1])
        self.net = _ref_net(params)
        with par.use_mesh(self.mesh):
            self.tr = par.ShardedTrainer(
                self.net, "adam", loss=loss,
                optimizer_params={"learning_rate": LR}, mesh=self.mesh,
                **kw)

    def step(self, data, *labels):
        with par.use_mesh(self.mesh):
            out = self.tr.step(mx.nd.array(data, dtype="int32"),
                               tuple(mx.nd.array(x) for x in labels))
        if isinstance(out, tuple):
            return float(out[0].asnumpy()), bool(out[1].asnumpy())
        return float(out.asnumpy())

    def params(self):
        return {k: p.data().asnumpy()
                for k, p in self.net._collect_params_with_prefix().items()}


def _port(params, loss=tloss, **kw):
    return ShardedTrainer(_port_net(params), "adam", loss=loss,
                          optimizer_params={"learning_rate": LR}, **kw)


def _port_step(tr, data, *labels):
    out = tr.step(data, labels)
    if isinstance(out, tuple):
        return float(out[0]), bool(out[1])
    return float(out)


def _params_close(port_tr, ref_params, tol=PARAM_TOL):
    for k, p in port_tr.net.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(), ref_params[k],
                                    atol=tol, rtol=0, err_msg=k)


def _snapshot(tr):
    return [x.clone() for x in [p for _, p in tr._trainable]
            + tr._state_flat]


def test_three_adam_steps_match_reference(params):
    ref, tr = _Ref(params), _port(params)
    for step in range(3):
        toks, labels = _batch(step)
        want = ref.step(toks, labels)
        loss = tr.step(toks, labels)
        assert loss.dim() == 0 and loss.device.type == "cpu"
        assert float(loss) == pytest.approx(want, rel=LOSS_RTOL)
    _params_close(tr, ref.params())
    assert tr.stats() == {"num_update": 3, "built": True, "guarded": False}
    assert [n for n, _ in tr._trainable] == \
        list(ref.net._collect_params_with_prefix())


def test_step1_gradients_match_reference(params):
    """The gradient the first step applies: the reference's autograd on
    its net, the port's on the copied net, in training mode."""
    toks, labels = _batch(0)
    jn = _ref_net(params)
    with mx.autograd.record():
        lval = jloss(jn(mx.nd.array(toks, dtype="int32")),
                     mx.nd.array(labels, dtype="int32"))
    lval.backward()
    tn = _port_net(params)
    with training_mode(True):
        tl = tloss(tn(torch.from_numpy(toks)), torch.from_numpy(labels))
    names = [n for n, _ in tn.named_parameters()]
    grads = torch.autograd.grad(tl, list(tn.parameters()))
    ref = jn._collect_params_with_prefix()
    assert float(tl.detach()) == pytest.approx(
        float(lval.asnumpy()), rel=LOSS_RTOL)
    for name, g in zip(names, grads):
        onp.testing.assert_allclose(g.numpy(), ref[name].grad().asnumpy(),
                                    atol=GRAD_TOL, rtol=0, err_msg=name)


def test_grad_accum_matches_reference(params):
    ref, tr = _Ref(params, grad_accum=2), _port(params, grad_accum=2)
    for step in range(2):
        toks, labels = _batch(10 + step)
        assert _port_step(tr, toks, labels) == pytest.approx(
            ref.step(toks, labels), rel=LOSS_RTOL)
    _params_close(tr, ref.params())
    with pytest.raises(MXNetError):
        tr.step(toks[:3], labels[:3])


def test_guarded_nonfinite_step_is_a_bit_identical_noop(params):
    """Step 2's loss is NaN: the port reports all_finite False and leaves
    parameters and Adam state bit-identical; steps 1 and 3 update, and
    the run ends where the reference's does."""
    kw = dict(guard_nonfinite=True)
    ref = _Ref(params, loss=_poisoned_loss(jloss), **kw)
    tr = _port(params, loss=_poisoned_loss(tloss), **kw)
    poison = [onp.zeros(B, "float32"), onp.full(B, onp.nan, "float32"),
              onp.zeros(B, "float32")]
    for step in range(3):
        toks, labels = _batch(20 + step)
        before = _snapshot(tr)
        loss, ok = _port_step(tr, toks, labels, poison[step])
        want_loss, want_ok = ref.step(toks, labels, poison[step])
        assert ok == want_ok == (step != 1)
        if ok:
            assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
        else:
            after = _snapshot(tr)
            assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert tr.optimizer.num_update == 3
    _params_close(tr, ref.params())


def test_clip_global_norm_matches_reference(params):
    ref = _Ref(params, clip_global_norm=0.05)
    tr = _port(params, clip_global_norm=0.05)
    for step in range(2):
        toks, labels = _batch(30 + step)
        loss, ok = _port_step(tr, toks, labels)
        assert ok and loss == pytest.approx(ref.step(toks, labels)[0],
                                            rel=LOSS_RTOL)
    _params_close(tr, ref.params())


def test_loss_scaler_schedule_matches_reference(params):
    """Scale 16, factor 2, window 2: two finite steps grow it to 32, a
    NaN step shrinks it to 16 and leaves the weights, a finite step
    follows.  The scale and the weights agree with the reference's at
    every step; the scaler object's own schedule agrees too."""
    ref = _Ref(params, loss=_poisoned_loss(jloss),
               loss_scaler=jamp.LossScaler(16.0, 2.0, 2))
    tr = _port(params, loss=_poisoned_loss(tloss),
               loss_scaler=tamp.LossScaler(16.0, 2.0, 2))
    nan = onp.full(B, onp.nan, "float32")
    ok_ = onp.zeros(B, "float32")
    scales = []
    for step, poison in enumerate([ok_, ok_, nan, ok_]):
        toks, labels = _batch(40 + step)
        _port_step(tr, toks, labels, poison)
        ref.step(toks, labels, poison)
        scales.append(tr.loss_scale)
        assert tr.loss_scale == ref.tr.loss_scale
    assert scales == [16.0, 32.0, 16.0, 16.0]
    _params_close(tr, ref.params())
    js, ts = jamp.LossScaler(8.0, 2.0, 3), tamp.LossScaler(8.0, 2.0, 3)
    for skip in [False, False, False, True, True, False, True, True, True]:
        js.update_scale(skip)
        ts.update_scale(skip)
        assert ts.loss_scale == js.loss_scale


def test_resume_from_reference_state_dict_and_states_file(params, tmp_path):
    """Two reference steps, then the port resumes from the reference's
    ``state_dict()`` (through ``load_numpy_state``) and, separately, from
    its parameters plus its ``save_states`` file; one more step on each
    side agrees."""
    ref = _Ref(params)
    for step in range(2):
        ref.step(*_batch(50 + step))
    sd = {k: v.asnumpy() for k, v in ref.tr.state_dict().items()}
    fname = str(tmp_path / "ref.states")
    ref.tr.save_states(fname)
    mid = ref.params()

    from_sd = load_numpy_state(_port(params), sd)
    assert from_sd.optimizer.num_update == 2
    from_file = ShardedTrainer(_port_net(mid), "adam", loss=tloss,
                               optimizer_params={"learning_rate": LR})
    from_file.load_states(fname)           # applied when the states exist
    toks, labels = _batch(52)
    want = ref.step(toks, labels)
    for tr in (from_sd, from_file):
        assert _port_step(tr, toks, labels) == pytest.approx(
            want, rel=LOSS_RTOL)
        assert tr.optimizer.num_update == 3
        _params_close(tr, ref.params())
    # and back: the port's own state dict and states file round-trip
    again = load_numpy_state(_port(params), from_sd.state_dict())
    for a, b in zip(_snapshot(again), _snapshot(from_sd)):
        assert torch.equal(a, b)
    bad = dict(sd)
    bad.pop("state:0")
    with pytest.raises(MXNetError):
        load_numpy_state(_port(params), bad)


@pytest.mark.parametrize("name,kw", [
    ("FactorScheduler", dict(step=7, factor=0.5, warmup_steps=5,
                             warmup_begin_lr=0.001)),
    ("MultiFactorScheduler", dict(step=[10, 20, 35], factor=0.3)),
    ("PolyScheduler", dict(max_update=40, pwr=2, warmup_steps=4,
                           warmup_mode="constant")),
    ("CosineScheduler", dict(max_update=45, final_lr=0.001,
                             warmup_steps=6)),
])
def test_lr_schedulers_match_reference(name, kw):
    js = getattr(jlrs, name)(base_lr=0.1, **kw)
    ts = getattr(tlrs, name)(base_lr=0.1, **kw)
    for n in range(50):
        assert ts(n) == js(n)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9, wd=0.01)),
    ("nag", dict(momentum=0.8, wd=0.02, clip_gradient=0.5)),
    ("adamw", dict(wd=0.05, rescale_grad=0.5)),
    ("sgd", dict(wd=0.01)),
])
def test_optimizer_updates_match_reference(name, kw):
    rs = onp.random.RandomState(7)
    w0 = rs.randn(6, 5).astype("float32")
    grads = [rs.randn(6, 5).astype("float32") for _ in range(3)]
    jo = jopt.create(name, learning_rate=0.1, **kw)
    to = topt.create(name.upper(), learning_rate=0.1, **kw)
    jw = mx.nd.array(w0)
    tw = torch.from_numpy(w0.copy())
    jst = jo.create_state_multi_precision(0, jw)
    tst = to.create_state_multi_precision(0, tw)
    for g in grads:
        jo.update_multi_precision(0, jw, mx.nd.array(g), jst)
        to.update_multi_precision(0, tw, torch.from_numpy(g), tst)
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), atol=1e-6, rtol=0)
    assert to.num_update == jo.num_update == 3
    with pytest.raises(MXNetError):
        topt.create("no_such_optimizer")


def test_mesh_of_more_than_one_device_raises(params):
    net = _port_net(params)
    for mesh in (2, [torch.device("cpu")] * 2):
        with pytest.raises(MXNetError, match="queue A6"):
            ShardedTrainer(net, "adam", loss=tloss, mesh=mesh)
    with pytest.raises(MXNetError, match="queue A6"):
        ShardedTrainer(net, "adam", loss=tloss, seq_axis=1)
    tr = ShardedTrainer(net, "adam", loss=tloss,
                        mesh=[torch.device("cpu")])
    assert isinstance(tr.step(*_batch(60)), torch.Tensor)


def test_dropout_repeats_with_the_seed(params):
    """Dropout 0.1 draws from ``mx.random``'s per-device generator: the
    same seed repeats a two-step loss trajectory, another seed does
    not."""
    def run(seed):
        tmx.random.seed(seed)
        tr = ShardedTrainer(_port_net(params, dropout=0.1), "adam",
                            loss=tloss,
                            optimizer_params={"learning_rate": LR})
        return [float(tr.step(*_batch(70 + i))) for i in range(2)]

    first = run(3)
    assert run(3) == first
    assert run(4) != first
    # no dropout outside training mode
    net = _port_net(params, dropout=0.1)
    toks = torch.from_numpy(_batch(0)[0])
    assert torch.equal(net(toks), net(toks))
