"""The port's optimizers against the JAX package's.

Every registered optimizer (13, with RMSProp ``centered``, LAMB's bounds
and no bias correction, LARS and Signum without momentum as extra cases)
takes 3 updates of the same weights and gradients, made from a seed, in
both packages: counted (each index's own update count) and under
``Optimizer.traced(lr, t)``, the contract ``ShardedTrainer`` relies on.
The port's per-parameter ``update`` is held to the reference at rtol
1e-5, atol 1e-6 (weights and every state leaf); its list-wise
``update_multi`` to the per-parameter one at 1e-6.  Then the state layout
and the trainers: the guarded ``ShardedTrainer`` step leaves parameters
and states bit-identical on a non-finite gradient, and ``gluon.Trainer``
state files round-trip within the port and load in the reference.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import optimizer as jopt
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.parallel import ShardedTrainer

torch.set_num_threads(1)

NAMES = ["sgd", "nag", "adam", "adamw", "rmsprop", "adagrad", "adadelta",
         "adamax", "ftrl", "lamb", "lars", "signum", "dcasgd"]
# every registered optimizer, plus the options with their own code paths
CASES = [(n, {}) for n in NAMES] + [
    ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
    ("dcasgd", {"momentum": 0.9}), ("rmsprop", {"centered": True}),
    ("lamb", {"lower_bound": 0.5, "upper_bound": 2.0}),
    ("lamb", {"bias_correction": False}), ("lars", {"momentum": 0.0}),
    ("signum", {"momentum": 0.0, "wd_lh": 0.01})]
COMMON = dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5,
              clip_gradient=1.0)
# the weights: a matrix, a vector, a 3-d block and an all-zero vector
# (LAMB's and LARS's norm guards)
SHAPES = [(4, 3), (5,), (2, 3, 2), (3,)]
RTOL, ATOL, MULTI_TOL = 1e-5, 1e-6, 1e-6


def test_every_reference_optimizer_is_registered():
    ref = {n.lower() for n in jopt._registry._entries}
    assert ref == set(NAMES) == set(topt._registry._entries)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.detach().numpy()


def _draws(rs):
    ws = [rs.randn(*s).astype("float32") for s in SHAPES]
    ws[-1][:] = 0
    return ws, [[rs.randn(*s).astype("float32") * 3 for s in SHAPES]
                for _ in range(3)]


def _run_ref(name, kw, ws, gss, traced):
    opt = jopt.create(name, **COMMON, **kw)
    w = [mx.nd.array(x) for x in ws]
    st = [opt.create_state_multi_precision(i, x) for i, x in enumerate(w)]
    for t, gs in enumerate(gss, 1):
        for i, g in enumerate(gs):
            if traced:
                with opt.traced(COMMON["learning_rate"], t):
                    opt.update_multi_precision(i, w[i], mx.nd.array(g),
                                               st[i])
            else:
                opt.update_multi_precision(i, w[i], mx.nd.array(g), st[i])
    return w, st


def _run_port(name, kw, ws, gss, traced, multi):
    opt = topt.create(name, **COMMON, **kw)
    w = [torch.from_numpy(x.copy()) for x in ws]
    st = [opt.create_state_multi_precision(i, x) for i, x in enumerate(w)]
    idx = list(range(len(w)))
    for t, gs in enumerate(gss, 1):
        g = [torch.from_numpy(x) for x in gs]
        ctx = opt.traced(COMMON["learning_rate"], t) if traced else None
        if ctx is not None:
            ctx.__enter__()
        try:
            if multi:
                opt.update_multi(idx, w, g, st)
            else:
                for i in idx:
                    opt.update_multi_precision(i, w[i], g[i], st[i])
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
    return w, st


@pytest.mark.parametrize("traced", [False, True],
                         ids=["counted", "traced"])
@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}{'-' if k else ''}"
                              f"{'-'.join(f'{a}={b}' for a, b in k.items())}"
                              for n, k in CASES])
def test_three_updates_match_reference(name, kw, traced):
    ws, gss = _draws(onp.random.RandomState(len(name) + 7 * len(kw)))
    rw, rst = _run_ref(name, kw, ws, gss, traced)
    pw, pst = _run_port(name, kw, ws, gss, traced, multi=False)
    mw, mst = _run_port(name, kw, ws, gss, traced, multi=True)
    for i in range(len(SHAPES)):
        ref = [rw[i]] + _leaves(rst[i])
        per = [pw[i]] + _leaves(pst[i])
        mul = [mw[i]] + _leaves(mst[i])
        assert len(ref) == len(per) == len(mul)
        for r, p, m in zip(ref, per, mul):
            assert _np(p).dtype == _np(r).dtype and p.shape == tuple(r.shape)
            onp.testing.assert_allclose(_np(p), _np(r), rtol=RTOL,
                                        atol=ATOL)
            onp.testing.assert_allclose(_np(m), _np(p), rtol=MULTI_TOL,
                                        atol=MULTI_TOL)


def test_list_wise_form_follows_the_rule_it_belongs_to():
    """A subclass that redefines ``update`` alone takes the per-parameter
    loop inside ``update_multi``; Ftrl has no list-wise form."""
    class Custom(topt.Adam):
        def update(self, index, weight, grad, state):
            self._update_count(index)
            weight.add_(1.0)

    assert topt.Adam._has_multi() and not Custom._has_multi()
    assert not topt.Ftrl._has_multi() and topt.DCASGD._has_multi()
    w = [torch.zeros(2), torch.zeros(3)]
    opt = Custom()
    opt.update_multi([0, 1], w, [torch.ones(2), torch.ones(3)],
                     [opt.create_state(i, x) for i, x in enumerate(w)])
    assert all(bool((x == 1).all()) for x in w)
    assert opt._index_update_count == {0: 1, 1: 1}


def _tiny_net():
    net = tmx.gluon.nn.Dense(4, in_units=3)
    net.initialize(device="cpu", seed=0)
    return net


def _poisoned(out, y, poison):
    return ((out - y) ** 2).mean() + poison.sum()


@pytest.mark.parametrize("name", NAMES)
def test_guarded_step_leaves_parameters_and_state_bit_identical(name):
    """One good step fills the state; a step whose gradient is NaN then
    leaves every parameter and state leaf bit-identical and reports
    ``all_finite`` False; the next good step proceeds."""
    rs = onp.random.RandomState(3)
    x, y = rs.randn(5, 3).astype("float32"), rs.randn(5, 4).astype("float32")
    tr = ShardedTrainer(_tiny_net(), name, loss=_poisoned,
                        optimizer_params={"learning_rate": 0.1, "wd": 0.01},
                        guard_nonfinite=True)
    ok = onp.zeros(5, "float32")
    _loss, finite = tr.step(x, (y, ok))
    assert bool(finite)
    before = {k: v.clone() for k, v in tr.state_dict().items()
              if not k.startswith("meta:")}
    _loss, finite = tr.step(x, (y, onp.full(5, onp.nan, "float32")))
    assert not bool(finite)
    after = tr.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    _loss, finite = tr.step(x, (y, ok))
    assert bool(finite) and not torch.equal(tr.state_dict()["param:0"],
                                            before["param:0"])


def _dense_pair(pkg):
    net = pkg.gluon.nn.Dense(8, in_units=16)
    if pkg is mx:
        net.initialize()
        handles = net._collect_params_with_prefix()
    else:
        net.initialize(ctx=tmx.cpu())
        handles = net.collect_params()
    for i, k in enumerate(["weight", "bias"]):
        rs = onp.random.RandomState(1000 + i)
        handles[k].set_data(pkg.nd.array(
            rs.randn(*handles[k].shape).astype("float32") * 0.1))
    return net


def _dense_steps(pkg, net, trainer, steps, seed=0):
    rs = onp.random.RandomState(seed)
    for _ in range(steps):
        x = pkg.nd.array(rs.randn(6, 16).astype("float32"))
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(6)


NEW = [("rmsprop", {}), ("rmsprop", {"centered": True}), ("adagrad", {}),
       ("adadelta", {}), ("adamax", {}), ("ftrl", {}), ("lamb", {}),
       ("lars", {}), ("signum", {}), ("dcasgd", {"momentum": 0.9})]


@pytest.mark.parametrize("name,kw", NEW, ids=[
    n + ("-centered" if k.get("centered") else "") for n, k in NEW])
def test_states_round_trip_and_load_in_the_reference(name, kw, tmp_path):
    """Two ``gluon.Trainer`` steps of a Dense layer, ``save_states``: a
    fresh port trainer on the same weights resumes bit for bit, and the
    reference's trainer loads the same file into states of its layout
    (tuple order, shapes, dtypes, values)."""
    opt = dict(learning_rate=0.01, wd=0.01, **kw)
    fname = str(tmp_path / "port.states")
    with tmx.cpu():
        a = _dense_pair(tmx)
        ta = tmx.gluon.Trainer(a.collect_params(), name, opt)
        _dense_steps(tmx, a, ta, 2)
        ta.save_states(fname)
        b = _dense_pair(tmx)
        for k, p in a.collect_params().items():
            b.collect_params()[k].set_data(p.data())
        tb = tmx.gluon.Trainer(b.collect_params(), name, opt)
        tb.load_states(fname)
        for net, tr in ((a, ta), (b, tb)):
            _dense_steps(tmx, net, tr, 1, seed=7)
        for k, p in a.collect_params().items():
            onp.testing.assert_array_equal(
                p.data().asnumpy(), b.collect_params()[k].data().asnumpy())
        port_states = {i: [_np(x) for x in _leaves(s)]
                       for i, s in ta._updaters[0].states.items()}
    ta.save_states(fname)
    ref = _dense_pair(mx)
    tr = mx.gluon.Trainer(ref.collect_params(), name, opt)
    tr.load_states(fname)
    ref_states = tr._updaters[0].states
    assert sorted(ref_states) == sorted(port_states)
    for i, leaves in port_states.items():
        got = [_np(x) for x in _leaves(ref_states[i])]
        assert len(got) == len(leaves)
        for g, w in zip(got, leaves):
            assert g.dtype == w.dtype and g.shape == w.shape
            onp.testing.assert_array_equal(g, w)
