"""The port's Module surface (``mx.mod``, ``mx.metric``, ``mx.callback``,
``mx.model``, ``mx.monitor``) against the JAX package's, on the CPU.

Mirrors the Module cases of ``tests/test_io_module.py``,
``test_symbol_autovar.py:86`` and ``test_compat_modules.py:12-48``:
``Module.fit`` of the classic MLP symbol from the same initial
parameters ends at the reference's parameters and score; every metric
reads the reference's value from the same predictions and labels;
checkpoints cross both ways; the Monitor records the reference's names.
Tolerances: 1e-5 absolute on parameters after a few epochs of SGD with
momentum (float32 sums over each batch taken in another order, carried
through the updates), the reference's 1e-5 relative / 1e-6 absolute
elsewhere.
"""
import logging
import os

import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P

RTOL, ATOL = 1e-5, 1e-6


def _data(n=120, seed=0):
    rs = onp.random.RandomState(seed)
    X = rs.randn(n, 1, 6, 6).astype("f") * 0.1
    y = rs.randint(0, 6, n)
    X[onp.arange(n), 0, 0, y] += 3.0
    return X, y.astype("f")


def _mlp(mx):
    data = mx.sym.Variable("data")
    flat = mx.sym.reshape(data, shape=(-1, 36))
    h = mx.sym.Activation(mx.sym.FullyConnected(
        flat, num_hidden=16, name="fc1"), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        h, num_hidden=6, name="fc2"), name="softmax")


def _init(seed=1):
    rs = onp.random.RandomState(seed)
    return {"fc1_weight": rs.randn(16, 36).astype("f") * 0.1,
            "fc1_bias": onp.zeros(16, "f"),
            "fc2_weight": rs.randn(6, 16).astype("f") * 0.1,
            "fc2_bias": onp.zeros(6, "f")}


def _cpu(mx):
    return P.cpu() if mx is P else R.cpu()


def _module(mx, sym, **kw):
    if mx is P:
        kw["context"] = P.cpu()
    return mx.mod.Module(sym, **kw)


def _fit(mx, optimizer, params, epochs):
    X, y = _data()
    it = mx.io.NDArrayIter(X, y, 40)
    mod = _module(mx, _mlp(mx), label_names=("softmax_label",))
    with _cpu(mx):
        mod.fit(it, eval_data=it, optimizer=optimizer,
                optimizer_params=params,
                arg_params={k: mx.nd.array(v) for k, v in _init().items()},
                eval_metric="acc", num_epoch=epochs)
        arg, _aux = mod.get_params()
        score = mod.score(it, mx.metric.Accuracy())
        pred = mod.predict(it).asnumpy()
    return {k: v.asnumpy() for k, v in arg.items()}, score, pred


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
])
def test_module_fit_matches_the_reference(optimizer, params):
    """fit (with the reference's rescale_grad = 1/batch default), then
    score and predict: the reference's parameters, accuracy and
    outputs."""
    r_arg, r_score, r_pred = _fit(R, optimizer, params, 3)
    p_arg, p_score, p_pred = _fit(P, optimizer, params, 3)
    assert set(p_arg) == set(r_arg)
    for k in r_arg:
        assert not onp.allclose(r_arg[k], _init()[k]), k
        onp.testing.assert_allclose(p_arg[k], r_arg[k], rtol=0, atol=1e-5,
                                    err_msg=k)
    assert p_score == r_score and p_score[0][1] > 0.5
    onp.testing.assert_allclose(p_pred, r_pred, rtol=0, atol=1e-5)


def test_module_forward_backward_update_loop():
    """The explicit loop (bind, init_params, init_optimizer, forward,
    backward, update, get_outputs, get_input_grads) as the reference."""
    X, y = _data(40, seed=3)
    got = {}
    for mx in (R, P):
        it = mx.io.NDArrayIter(X, y, 20)
        mod = _module(mx, _mlp(mx), label_names=("softmax_label",))
        with _cpu(mx):
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label, inputs_need_grad=True)
            mod.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in _init(2).items()})
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params=(("learning_rate", 0.5),))
            outs = []
            for batch in it:
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
                outs.append(mod.get_outputs()[0].asnumpy())
            grads = mod.get_input_grads()[0].asnumpy()
        got[mx] = (outs, grads, {k: v.asnumpy()
                                 for k, v in mod.get_params()[0].items()},
                   mod.output_shapes)
    for a, b in zip(got[P][0], got[R][0]):
        onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(got[P][1], got[R][1], rtol=RTOL, atol=ATOL)
    for k in got[R][2]:
        onp.testing.assert_allclose(got[P][2][k], got[R][2][k], rtol=RTOL,
                                    atol=ATOL)
    assert got[P][3] == got[R][3]


def test_bucketing_module_as_the_reference():
    """One bound module per bucket, parameters shared on a switch, the
    outputs of each bucket the reference's."""
    w = onp.random.RandomState(5).uniform(-1, 1, (2, 8)).astype("f")
    x8 = onp.random.RandomState(6).uniform(-1, 1, (4, 8)).astype("f")
    x16 = onp.random.RandomState(7).uniform(-1, 1, (4, 16)).astype("f")
    got = {}
    for mx in (R, P):
        sym = mx.sym

        def sym_gen(seq_len):
            data = sym.Variable("data")
            wv = sym.Variable("w", shape=(2, 8))
            fc = sym.FullyConnected(sym.reshape(data, shape=(-1, 8)), wv,
                                    None, num_hidden=2, no_bias=True)
            return sym.softmax(fc, axis=-1), ("data",), ()

        kw = {"context": P.cpu()} if mx is P else {}
        bm = mx.mod.BucketingModule(sym_gen, default_bucket_key=8, **kw)
        with _cpu(mx):
            bm.bind(data_shapes=[mx.io.DataDesc("data", (4, 8))])
            bm.init_params(arg_params={"w": mx.nd.array(w)})
            outs = []
            for key, x in ((8, x8), (16, x16), (8, x8)):
                b = mx.io.DataBatch(
                    [mx.nd.array(x)],
                    provide_data=[mx.io.DataDesc("data", x.shape)],
                    provide_label=[])
                b.bucket_key = key
                bm.forward(b, is_train=False)
                outs.append(bm.get_outputs()[0].asnumpy())
        got[mx] = (outs, sorted(bm._buckets),
                   bm._buckets[16].get_params()[0]["w"].asnumpy())
    for a, b in zip(got[P][0], got[R][0]):
        onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert got[P][1] == got[R][1] == [8, 16]
    onp.testing.assert_allclose(got[P][2], w)


_METRICS = [
    ("acc", {}), ("top_k_accuracy", {"top_k": 3}), ("f1", {}),
    ("mcc", {}), ("mae", {}), ("mse", {}), ("rmse", {}), ("ce", {}),
    ("perplexity", {"ignore_label": 2}), ("pearsoncorrelation", {}),
    ("loss", {}),
    ("composite", {}), ("custom", {}),
]


def _metric(mx, name, kw):
    if name == "composite":
        return mx.metric.CompositeEvalMetric(["acc", "ce"])
    if name == "custom":
        return mx.metric.np(lambda l, p: float(onp.abs(l - p.argmax(-1))
                                               .sum()), name="l1")
    return mx.metric.create(name, **kw)


@pytest.mark.parametrize("name,kw", _METRICS, ids=[m for m, _ in _METRICS])
def test_every_metric_reads_the_reference(name, kw):
    """Each metric's name and value, local and global, after updates from
    the same labels and predictions (NDArrays in each package)."""
    rs = onp.random.RandomState(11)
    binary = name in ("f1", "mcc")
    regress = name in ("mae", "mse", "rmse", "pearsoncorrelation", "loss")
    batches = []
    for _ in range(3):
        if binary:
            lab = rs.randint(0, 2, 8).astype("f")
            pred = rs.uniform(0, 1, (8, 2)).astype("f")
        elif regress:
            lab = rs.randn(8).astype("f")
            pred = (lab + rs.randn(8) * 0.3).astype("f")
        else:
            lab = rs.randint(0, 5, 8).astype("f")
            pred = rs.dirichlet(onp.ones(5), 8).astype("f")
        batches.append((lab, pred))
    got = {}
    for mx in (R, P):
        m = _metric(mx, name, kw)
        with _cpu(mx):
            m.update([mx.nd.array(batches[0][0])],
                     [mx.nd.array(batches[0][1])])
            m.reset_local()
            for lab, pred in batches[1:]:
                m.update([mx.nd.array(lab)], [mx.nd.array(pred)])
        # (a composite keeps no global sums of its own, in either
        # package: its children keep them)
        got[mx] = (m.get(), m.get_name_value(),
                   None if name == "composite" else m.get_global())
    assert repr(got[P]) == repr(got[R]) or _close(got[P], got[R])


def _close(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, str):
        return a == b
    return onp.isclose(float(a), float(b), rtol=RTOL, atol=ATOL,
                       equal_nan=True)


def test_speedometer_and_progress_lines(caplog):
    """Speedometer logs the reference's line (speed apart) every
    ``frequent`` batches and resets the metric; log_train_metric and
    ProgressBar log as the reference's."""
    lines = {}
    for mx in (R, P):
        metric = mx.metric.Accuracy()
        with _cpu(mx):
            metric.update([mx.nd.array([1.0, 0.0])],
                          [mx.nd.array([[0.1, 0.9], [0.8, 0.2]])])
        cbs = [mx.callback.Speedometer(2, frequent=2),
               mx.callback.log_train_metric(2),
               mx.callback.ProgressBar(4, length=8)]
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for nbatch in range(5):
                p = mx.callback.BatchEndParam(epoch=1, nbatch=nbatch,
                                              eval_metric=metric,
                                              locals=None)
                for cb in cbs:
                    cb(p)
        lines[mx] = [r.getMessage().split("Speed:")[0]
                     for r in caplog.records]
        assert metric.num_inst == 0          # auto_reset
    assert lines[P] == lines[R] and lines[P]
    assert P.model.BatchEndParam is P.callback.BatchEndParam


@pytest.mark.parametrize("src,dst", [(R, P), (P, R)],
                         ids=["ref_to_port", "port_to_ref"])
def test_checkpoints_cross_both_ways(tmp_path, src, dst):
    """model.save_checkpoint / do_checkpoint files of one package load in
    the other (model.load_checkpoint, Module.load), symbol and params
    alike."""
    init = _init(4)
    aux = {"bn_moving_mean": onp.ones(4, "f")}
    prefix = str(tmp_path / "m")
    with _cpu(src):
        sym = _mlp(src)
        cb = src.callback.do_checkpoint(prefix, period=2)
        args = {k: src.nd.array(v) for k, v in init.items()}
        auxs = {k: src.nd.array(v) for k, v in aux.items()}
        cb(0, sym, args, auxs)                       # epoch 1: skipped
        assert not os.path.exists(f"{prefix}-0001.params")
        cb(1, sym, args, auxs)                       # epoch 2: written
    with _cpu(dst):
        sym2, arg2, aux2 = dst.model.load_checkpoint(prefix, 2)
        assert sym2.list_arguments() == sym.list_arguments()
        for k, v in init.items():
            onp.testing.assert_array_equal(arg2[k].asnumpy(), v)
        onp.testing.assert_array_equal(aux2["bn_moving_mean"].asnumpy(),
                                       aux["bn_moving_mean"])
        mod = dst.mod.Module.load(prefix, 2, label_names=("softmax_label",),
                                  **({"context": P.cpu()} if dst is P
                                     else {}))
        X, y = _data(40)
        it = dst.io.NDArrayIter(X, y, 20)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params()
        got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k, v in init.items():
        onp.testing.assert_array_equal(got[k], v)


def test_module_save_checkpoint_with_optimizer_states(tmp_path):
    """Module.save_checkpoint(save_optimizer_states=True) writes the
    symbol, params and states files of the reference's names."""
    X, y = _data(40)
    it = P.io.NDArrayIter(X, y, 20)
    mod = _module(P, _mlp(P), label_names=("softmax_label",))
    with P.cpu():
        mod.fit(it, optimizer="adam", num_epoch=1,
                arg_params={k: P.nd.array(v) for k, v in _init().items()})
        prefix = str(tmp_path / "mm")
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    for suffix in ("-symbol.json", "-0001.params", "-0001.states"):
        assert os.path.exists(prefix + suffix)
    sym, arg, _aux = R.model.load_checkpoint(prefix, 1)
    assert sorted(arg) == sorted(_init())


def _monitored(mx, mon):
    X, y = _data(20)
    it = mx.io.NDArrayIter(X, y, 20)
    mod = _module(mx, _mlp(mx), label_names=("softmax_label",))
    with _cpu(mx):
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in _init().items()})
        mod.install_monitor(mon)
        try:
            mon.tic()
            mod.forward(next(iter(it)), is_train=False)
            res = mon.toc()
        finally:
            mon.uninstall()
    return res


@pytest.mark.parametrize("pattern", [".*", ".*FullyConnected.*"])
def test_monitor_records_the_reference_names(pattern):
    """On a Module's executor the Monitor records the reference's op
    names with the reference's statistics."""
    got = {mx: _monitored(mx, mx.mon.Monitor(1, pattern=pattern, sort=True))
           for mx in (R, P)}
    assert [n for _, n, _ in got[P]] == [n for _, n, _ in got[R]]
    assert got[P]
    for (_, _, a), (_, _, b) in zip(got[P], got[R]):
        onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_monitor_on_blocks_interval_and_nonfinite():
    """On a Gluon layer the Monitor records it under the reference's op
    name; ``interval`` skips batches; ``nonfinite`` finds the first
    op that made a NaN."""
    x = onp.ones((2, 3), "f")
    names = {}
    for mx in (R, P):
        net = mx.gluon.nn.Dense(4, in_units=3)
        with _cpu(mx):
            net.initialize()
            mon = mx.mon.Monitor(interval=1, pattern=".*FullyConnected.*")
            mon.install()
            try:
                mon.tic()
                net(mx.nd.array(x))
                names[mx] = [n for _, n, _ in mon.toc()]
            finally:
                mon.uninstall()
    assert names[P] == names[R] == ["FullyConnected0"]
    with P.cpu():
        net = P.gluon.nn.Dense(4, in_units=3)
        net.initialize()
        mon = P.mon.Monitor(interval=2, pattern=".*").install()
        try:
            mon.tic(); net(P.nd.array(x)); first = mon.toc()
            mon.tic(); net(P.nd.array(x)); second = mon.toc()
        finally:
            mon.uninstall()
        assert first and not second and not mon.installed
        mon = P.mon.Monitor.nonfinite()
        with mon:
            a = P.nd.array(onp.array([1.0, -1.0], "f"))
            P.nd.sqrt(a) + 1.0
            found = mon.first_nonfinite()
        assert found is not None and found[1] == "sqrt0"
