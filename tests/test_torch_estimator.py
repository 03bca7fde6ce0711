"""The port's ``gluon.contrib`` (the estimator, its event handlers and
``Concurrent``) against the JAX package's, on the CPU.

Each fit runs both packages from one set of seeded weights on the same
batches (``DataLoader`` without shuffling): the losses, metrics and
parameters after training agree at 1e-5 (float32 Adam or SGD over a few
dozen steps of a 6-16-2 MLP), and checkpoint files cross packages.
"""
import os

import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu.gluon.contrib import estimator as RE
from mxnet_tpu_torch.gluon.contrib import estimator as PE
from mxnet_tpu_torch.utils.convert import load_numpy_params
from torch_ref_nets import seeded

TOL = 1e-5


def _loader(mx, n=64, batch=16, seed=0):
    rs = onp.random.RandomState(seed)
    X = rs.randn(n, 6).astype("float32")
    y = (X.sum(1) > 0).astype("float32")
    ds = mx.gluon.data.ArrayDataset(mx.nd.array(X), mx.nd.array(y))
    return mx.gluon.data.DataLoader(ds, batch_size=batch)


def _net(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=6),
            mx.gluon.nn.Dense(2, in_units=16))
    return net


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _nets():
    with seeded(0):
        ref = _net(R)
        ref.initialize(R.init.Xavier())
    with P.cpu():
        port = load_numpy_params(_net(P), _params(ref))
    return ref, port


def _estimators(opt="adam", lr=0.01, **kw):
    ref, port = _nets()
    out = []
    for mx, E, net in ((R, RE, ref), (P, PE, port)):
        trainer = mx.gluon.Trainer(net.collect_params(), opt,
                                   {"learning_rate": lr})
        out.append(E.Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               trainer=trainer, **kw))
    return out


def _agree_params(ref, port):
    want, got = _params(ref), _params(port)
    assert got.keys() == want.keys()
    for k in want:
        onp.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)


def test_fit_equals_the_reference():
    """Five epochs of Adam: train accuracy and loss metrics and the
    parameters equal the reference's; the loss falls."""
    re_, pe = _estimators()
    re_.fit(_loader(R), epochs=5)
    with P.cpu():
        pe.fit(_loader(P), epochs=5)
    for a, b in ((pe.train_metrics[0], re_.train_metrics[0]),
                 (pe.train_loss_metric, re_.train_loss_metric)):
        assert a.get()[0] == b.get()[0]
        onp.testing.assert_allclose(a.get()[1], b.get()[1], rtol=TOL)
    assert pe.train_metrics[0].get()[1] > 0.8
    assert pe.train_loss_metric.get()[1] < 0.7
    _agree_params(re_.net, pe.net)


def test_validation_and_early_stopping_equal_the_reference():
    """Validation runs before the stopper reads its metric; both
    packages stop at the same epoch with the same validation metrics; a
    second fit starts the handler afresh."""
    re_, pe = _estimators()
    stops = []
    for mx, E, est in ((R, RE, re_), (P, PE, pe)):
        stop = E.EarlyStoppingHandler(monitor=est.val_metrics[0],
                                      patience=1, mode="max")
        with (P.cpu() if mx is P else R.cpu()):
            est.fit(_loader(mx), val_data=_loader(mx, seed=1), epochs=30,
                    event_handlers=[stop])
            stops.append(stop.stopped_epoch)
            assert not onp.isnan(est.val_metrics[0].get()[1])
            est.fit(_loader(mx), val_data=_loader(mx, seed=1), epochs=2,
                    event_handlers=[stop])
            assert stop.current_epoch >= 1
    assert 0 < stops[1] < 30 and stops[0] == stops[1]
    onp.testing.assert_allclose(pe.val_metrics[0].get()[1],
                                re_.val_metrics[0].get()[1], rtol=TOL)
    onp.testing.assert_allclose(pe.val_loss_metric.get()[1],
                                re_.val_loss_metric.get()[1], rtol=TOL)


def test_checkpoints_rotate_and_cross_packages(tmp_path):
    """``CheckpointHandler`` writes the reference's names, keeps
    ``max_checkpoints`` and the best; the port's ``.params`` load into the
    reference (and the reference's into the port) with equal outputs."""
    re_, pe = _estimators(opt="sgd", lr=0.1)
    dirs = {}
    for mx, E, est in ((R, RE, re_), (P, PE, pe)):
        d = tmp_path / mx.__name__
        dirs[mx] = d
        ckpt = E.CheckpointHandler(str(d), model_prefix="m", epoch_period=1,
                                   max_checkpoints=2, save_best=True,
                                   mode="max", monitor=est.train_metrics[0])
        with (P.cpu() if mx is P else R.cpu()):
            est.fit(_loader(mx), epochs=4, event_handlers=[ckpt])
    assert sorted(os.listdir(dirs[P])) == sorted(os.listdir(dirs[R])) == [
        "m-best.params", "m-best.states", "m-epoch3.params",
        "m-epoch3.states", "m-epoch4.params", "m-epoch4.states"]
    x = onp.random.RandomState(5).randn(3, 6).astype("f")
    ref2 = _net(R)
    ref2.load_parameters(str(dirs[P] / "m-epoch4.params"))
    want = re_.net(R.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(ref2(R.nd.array(x)).asnumpy(), want,
                                rtol=TOL, atol=TOL)
    with P.cpu():
        port2 = _net(P)
        port2.load_parameters(str(dirs[R] / "m-epoch4.params"))
        got = port2(P.nd.array(x)).asnumpy()
        assert onp.array_equal(pe.net(P.nd.array(x)).asnumpy(),
                               _reloaded(dirs[P] / "m-epoch4.params", x))
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _reloaded(path, x):
    net = _net(P)
    net.load_parameters(str(path))
    return net(P.nd.array(x)).asnumpy()


def test_fit_needs_a_stopping_criterion_and_honours_batches():
    re_, pe = _estimators()
    with P.cpu():
        with pytest.raises(ValueError):
            pe.fit(_loader(P))
        pe.fit(_loader(P), epochs=0)
        pe.fit(_loader(P), batches=3)
    re_.fit(_loader(R), epochs=0)
    re_.fit(_loader(R), batches=3)
    _agree_params(re_.net, pe.net)


def test_handlers_are_overridable_and_metrics_keep_their_settings():
    """A gradient handler that steps every second batch (the reference's
    accumulation case) trains like the reference's; the validation
    metrics copy the train metric's settings."""
    ref, port = _nets()
    data = onp.random.RandomState(3).randn(32, 6).astype("f")
    labels = onp.random.RandomState(4).randint(0, 2, (32,))
    for mx, E, net in ((R, RE, ref), (P, PE, port)):
        class EveryTwo(E.GradientUpdateHandler):
            def __init__(self):
                self.count = 0

            def batch_end(self, estimator, *args, **kwargs):
                self.count += 1
                if self.count % 2 == 0:
                    estimator.trainer.step(2 * estimator._batch_size)

        with (P.cpu() if mx is P else R.cpu()):
            batches = [(mx.nd.array(data[i:i + 8]),
                        mx.nd.array(labels[i:i + 8]))
                       for i in range(0, 32, 8)]
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 0.1})
            est = E.Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              trainer=trainer,
                              train_metrics=mx.metric.TopKAccuracy(top_k=2))
            h = EveryTwo()
            est.fit(batches, epochs=1, event_handlers=[h])
            assert h.count == 4 and est.train_loss_metric.num_inst > 0
            assert est.val_metrics[0].top_k == 2
    _agree_params(ref, port)


def test_concurrent_equals_the_reference():
    """``HybridConcurrent`` concatenates its branches along ``axis``, as
    the reference's does, hybridized or not; a swapped branch runs."""
    def make(mx):
        c = mx.gluon.contrib.nn.HybridConcurrent(axis=1)
        c.add(mx.gluon.nn.Dense(3, in_units=4),
              mx.gluon.nn.Dense(2, in_units=4, activation="relu"),
              mx.gluon.contrib.nn.Identity())
        return c

    with seeded(1):
        ref = make(R)
        ref.initialize(R.init.Xavier())
    x = onp.random.RandomState(2).randn(5, 4).astype("f")
    want = ref(R.nd.array(x)).asnumpy()
    with P.cpu():
        port = load_numpy_params(make(P), _params(ref))
        assert len(port) == 3 and isinstance(port[2], P.gluon.nn.Identity)
        got = port(P.nd.array(x)).asnumpy()
        port.hybridize()
        assert onp.array_equal(port(P.nd.array(x)).asnumpy(), got)
        port.register_child(P.gluon.contrib.nn.Identity(), "0")
        assert port(P.nd.array(x)).shape == (5, 10)
    assert P.gluon.contrib.nn.SyncBatchNorm is P.gluon.nn.SyncBatchNorm
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
