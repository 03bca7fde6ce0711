"""The port's symbolic API (``mx.sym``, ``symbol.passes``, ``mx.name``,
``mx.attribute``) against the JAX package's, on the CPU.

Mirrors ``tests/test_symbol.py``, ``test_symbol_autovar.py``,
``test_graph_passes.py`` and the name and attr cases of
``test_compat_modules.py``: graphs built in either package cross to the
other as JSON with the same arguments, aux states, shapes and outputs;
executors give the same outputs, gradients and moving statistics from
the same bindings; auto-created names and CSE merges are the
reference's.  Tolerances are the reference's own (1e-5 relative, 1e-6
absolute, ``tests/test_export.py``), except gradients through a
softmax head, held at 1e-5 absolute (float32 sums over a batch taken in
another order).
"""
import json

import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _anonymous_counters_equal():
    """Each package numbers anonymous nodes (and their auto-created
    parameters) from a process-wide counter, which other test files on
    the same worker advance unevenly: each test starts with the two
    counters equal, moved forward only, so names made before stay
    unique."""
    from mxnet_tpu import symbol as rsym
    from mxnet_tpu_torch import symbol as psym
    rsym._UID[0] = psym._UID[0] = max(rsym._UID[0], psym._UID[0])


def _mlp(mx):
    data = mx.sym.Variable("data")
    flat = mx.sym.reshape(data, shape=(-1, 12))
    h = mx.sym.Activation(mx.sym.FullyConnected(
        flat, num_hidden=16, name="fc1"), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        h, num_hidden=5, name="fc2"), name="softmax")


def _conv_bn(mx):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                           name="c1")
    bn = mx.sym.BatchNorm(c, name="bn1")
    act = mx.sym.Activation(bn, act_type="tanh")
    pool = mx.sym.Pooling(act, kernel=(2, 2), stride=(2, 2),
                          pool_type="max")
    return mx.sym.FullyConnected(mx.sym.flatten(pool), num_hidden=3,
                                 name="fc")


def _split(mx):
    data = mx.sym.Variable("data")
    parts = mx.sym.split(data, num_outputs=2, axis=1)
    return mx.sym.Group([mx.sym.exp(parts[0]) * 2.0 + parts[1],
                         mx.sym.sum(parts[1], axis=0, keepdims=True)])


def _scalars(mx):
    x = mx.sym.Variable("x")
    y = mx.sym.Variable("y")
    return mx.sym.tanh(x * y + 2.0) - 1.0 / (1.0 + mx.sym.square(x))


GRAPHS = {
    "mlp": (_mlp, {"data": (4, 3, 4)}),
    "conv_bn": (_conv_bn, {"data": (2, 3, 8, 8)}),
    "split": (_split, {"data": (3, 4)}),
    "scalars": (_scalars, {"x": (5,), "y": (5,)}),
}


def _bindings(sym, shapes, seed):
    """Random values for every argument and aux state, by name."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rs = onp.random.RandomState(seed)
    vals = {}
    names = sym.list_arguments() + sym.list_auxiliary_states()
    for n, s in zip(names, list(arg_shapes) + list(aux_shapes)):
        if n.endswith("label"):
            vals[n] = rs.randint(0, 5, s).astype("f")
        elif n.endswith("moving_var"):
            vals[n] = rs.uniform(0.5, 1.5, s).astype("f")
        else:
            vals[n] = rs.uniform(-1, 1, s).astype("f")
    return vals


def _eval(mx, sym, vals):
    if mx is P:
        with P.cpu():
            return [o.asnumpy() for o in sym.eval(
                **{k: P.nd.array(v) for k, v in vals.items()})]
    return [o.asnumpy() for o in sym.eval(
        **{k: R.nd.array(v) for k, v in vals.items()})]


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("src,dst", [(R, P), (P, R)],
                         ids=["ref_to_port", "port_to_ref"])
def test_json_crosses_both_ways(kind, src, dst):
    """A graph built and saved by one package loads in the other with the
    same arguments, aux states, inferred shapes and outputs."""
    build, shapes = GRAPHS[kind]
    with src.name.NameManager():
        a = build(src)
    b = dst.sym.load_json(a.tojson())
    assert b.list_arguments() == a.list_arguments()
    assert b.list_auxiliary_states() == a.list_auxiliary_states()
    assert b.list_outputs() == a.list_outputs()
    assert b.infer_shape(**shapes) == a.infer_shape(**shapes)
    vals = _bindings(a, shapes, seed=len(kind))
    for x, y in zip(_eval(dst, b, vals), _eval(src, a, vals)):
        onp.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    # node for node the same JSON (names, ops, attrs, inputs, heads)
    ja, jb = json.loads(a.tojson()), json.loads(b.tojson())
    assert ja["nodes"] == jb["nodes"] and ja["heads"] == jb["heads"]


def _executor(mx, sym, shapes, vals):
    if mx is P:
        with P.cpu():
            ex = sym.simple_bind(**shapes)
            ex.copy_params_from({k: P.nd.array(v) for k, v in vals.items()})
            outs = ex.forward(is_train=True)
            ex.backward()
    else:
        ex = sym.simple_bind(**shapes)
        ex.copy_params_from({k: R.nd.array(v) for k, v in vals.items()})
        outs = ex.forward(is_train=True)
        ex.backward()
    return ([o.asnumpy() for o in outs],
            {k: g.asnumpy() for k, g in ex.grad_dict.items()},
            {k: ex.arg_dict[k].asnumpy()
             for k in sym.list_auxiliary_states()})


@pytest.mark.parametrize("kind", ["mlp", "conv_bn", "scalars"])
def test_executor_forward_backward_and_aux_equal(kind):
    """simple_bind, copy_params_from, forward(is_train=True) and backward
    give the reference's outputs, every argument's gradient, and the
    BatchNorm moving statistics it moved."""
    build, shapes = GRAPHS[kind]
    with R.name.NameManager():
        rs = build(R)
    ps = P.sym.load_json(rs.tojson())
    vals = _bindings(rs, shapes, seed=7)
    r_out, r_grad, r_aux = _executor(R, rs, shapes, vals)
    p_out, p_grad, p_aux = _executor(P, ps, shapes, vals)
    for x, y in zip(p_out, r_out):
        onp.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    assert set(p_grad) == set(r_grad)
    for k in r_grad:
        onp.testing.assert_allclose(p_grad[k], r_grad[k], rtol=RTOL,
                                    atol=1e-5, err_msg=k)
    assert set(p_aux) == set(r_aux)
    for k in r_aux:
        assert not onp.allclose(r_aux[k], vals[k]), k   # they moved
        onp.testing.assert_allclose(p_aux[k], r_aux[k], rtol=RTOL,
                                    atol=ATOL, err_msg=k)


def test_executor_grad_req_and_explicit_bind():
    """bind with explicit arrays and grad_req per argument: 'null'
    arguments get no gradient, as in the reference."""
    xv = onp.array([1.0, 2.0, 3.0], "f")
    wv = onp.array([4.0, 5.0, 6.0], "f")
    got = {}
    for mx in (R, P):
        x, w = mx.sym.Variable("x"), mx.sym.Variable("w")
        y = mx.sym.sum(x * w * w)
        with (P.cpu() if mx is P else R.cpu()):
            ex = y.bind(args={"x": mx.nd.array(xv), "w": mx.nd.array(wv)},
                        args_grad={"x": mx.nd.zeros((3,)),
                                   "w": mx.nd.zeros((3,))},
                        grad_req={"x": "null", "w": "write"})
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward()
        got[mx] = (out, ex.grad_dict["x"].asnumpy(),
                   ex.grad_dict["w"].asnumpy())
    for a, b in zip(got[P], got[R]):
        onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    onp.testing.assert_array_equal(got[P][1], onp.zeros(3))


def test_auto_variable_names_equal():
    """Auto-created parameter and aux variables, keyword inputs, the
    label of a loss head and anonymous node names are the reference's."""
    def build(mx):
        d = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(d, num_hidden=8)
        fc2 = mx.sym.FullyConnected(data=fc, num_hidden=4, name="fc2")
        nb = mx.sym.FullyConnected(fc2, num_hidden=3, no_bias=True)
        conv = mx.sym.Convolution(mx.sym.reshape(nb, shape=(-1, 3, 1, 1)),
                                  kernel=(1, 1), num_filter=2)
        bn = mx.sym.BatchNorm(conv)
        return mx.sym.SoftmaxOutput(mx.sym.flatten(bn), name="softmax")
    with R.name.NameManager():
        r = build(R)
    with P.name.NameManager():
        p = build(P)
    assert p.list_arguments() == r.list_arguments()
    assert p.list_auxiliary_states() == r.list_auxiliary_states()
    assert "softmax_label" in p.list_arguments()
    assert p.infer_shape(data=(6, 5)) == r.infer_shape(data=(6, 5))
    assert json.loads(p.tojson())["nodes"] == json.loads(r.tojson())["nodes"]


def test_user_supplied_moving_stats_classify_as_aux():
    for mx in (R, P):
        d, g, b = (mx.sym.Variable(n) for n in ("data", "g", "b"))
        mm, mv = mx.sym.Variable("my_mean"), mx.sym.Variable("my_var")
        bn = mx.sym.BatchNorm(d, g, b, mm, mv, name="bn")
        assert bn.list_auxiliary_states() == ["my_mean", "my_var"]
        assert bn.list_arguments() == ["data", "g", "b"]


def test_batchnorm_output_mean_var_json_and_moving_stats():
    """A multi-output BatchNorm keeps its arity through JSON and still
    moves its moving statistics in training, as the reference's."""
    x = (onp.random.RandomState(1).randn(16, 6) * 4 + 5).astype("f")
    got = {}
    for mx in (R, P):
        d = mx.sym.Variable("data")
        bn = mx.sym.BatchNorm(d, output_mean_var=True, name="bnm")
        loss = mx.sym.MakeLoss(mx.sym.mean(bn[0] * bn[0] + bn[1]))
        loaded = mx.sym.load_json(loss.tojson())
        with (P.cpu() if mx is P else R.cpu()):
            ex = loaded.simple_bind(data=(16, 6))
            ex.copy_params_from({"data": mx.nd.array(x),
                                 "bnm_gamma": mx.nd.ones((6,)),
                                 "bnm_moving_var": mx.nd.ones((6,))})
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward()
        got[mx] = (out, ex.arg_dict["bnm_moving_mean"].asnumpy(),
                   ex.arg_dict["bnm_moving_var"].asnumpy(),
                   ex.grad_dict["data"].asnumpy())
    assert got[P][0].shape == ()
    for a, b in zip(got[P], got[R]):
        onp.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("case", ["exp_twice", "attrs", "split", "dropout",
                                  "identity"])
def test_passes_merge_what_the_reference_merges(case):
    """CommonSubexprElim and EliminateIdentity leave the reference's node
    count and ops; Dropout is never merged; the executor's default CSE
    is the reference's."""
    def build(mx):
        d = mx.sym.Variable("data")
        if case == "exp_twice":
            return mx.sym.exp(d) + mx.sym.exp(d), "CommonSubexprElim"
        if case == "attrs":
            return mx.sym.Group([mx.sym.sum(d, axis=0),
                                 mx.sym.sum(d, axis=0, keepdims=True),
                                 mx.sym.sum(d, axis=0)]), "CommonSubexprElim"
        if case == "split":
            s = mx.sym.split(d, num_outputs=2)
            t = mx.sym.split(d, num_outputs=2)
            return s[0] + t[1], "CommonSubexprElim"
        if case == "dropout":
            return (mx.sym.Dropout(d, p=0.5) + mx.sym.Dropout(d, p=0.5),
                    "CommonSubexprElim")
        return mx.sym.identity(mx.sym.identity(d)) + 1.0, "EliminateIdentity"
    counts = {}
    for mx in (R, P):
        with mx.name.NameManager():
            s, name = build(mx)
        opt = s.apply_pass(name)
        ops = sorted(n._op for n in mx.symbol._topo(opt))
        counts[mx] = (mx.symbol.passes.node_count(s),
                      mx.symbol.passes.node_count(opt), ops)
        with (P.cpu() if mx is P else R.cpu()):
            ex = s.simple_bind(data=(2, 4))
        counts[mx] += (sorted(n._op for n in mx.symbol._topo(ex._symbol)),)
    assert counts[P] == counts[R]


def test_pass_registry_and_unknown_pass():
    from mxnet_tpu_torch.symbol.passes import list_passes, register_pass

    @register_pass("PortTestPass")
    def _p(sym, **kw):
        return sym

    assert "PortTestPass" in list_passes()
    assert {"CommonSubexprElim", "EliminateIdentity"} <= set(list_passes())
    with pytest.raises(P.MXNetError):
        P.sym.Variable("x").apply_pass("NoSuchPass")


def test_name_and_attr_scopes_as_the_reference():
    """``mx.name.Prefix`` names symbols (explicit names too) and
    ``mx.attribute.AttrScope`` attaches attrs, nested scopes over outer
    ones, in both packages alike."""
    got = {}
    for mx in (R, P):
        with mx.name.Prefix("enc_"):
            first = mx.name.current().get(None, "dense")
            data = mx.sym.Variable("data")
            fc = mx.sym.FullyConnected(data, num_hidden=2)
            named = mx.sym.Activation(fc, act_type="relu", name="act")
        with mx.attribute.AttrScope(ctx_group="a", lr_mult="2"):
            with mx.attribute.AttrScope(ctx_group="b"):
                inner = mx.attribute.current_attrs()
                v = mx.sym.Variable("w")
            outer = mx.attribute.current_attrs()
        got[mx] = (first, fc.name, named.name, inner, outer,
                   dict(v._attrs), mx.attribute.current_attrs())
    assert got[P] == got[R]
    assert got[P][2] == "enc_act" and got[P][3]["ctx_group"] == "b"


def test_graph_surface_as_the_reference():
    """get_internals, indexing by name, groups, contrib ops and the
    symbolic creators evaluate as the reference's."""
    got = {}
    for mx in (R, P):
        with mx.name.NameManager():
            x = mx.sym.Variable("x")
            h = mx.sym.relu(x, name="h")
            y = mx.sym.sum(h, name="y")
            inner = y.get_internals()["h"]
            g = mx.sym.Group([mx.sym.relu(x), mx.sym.negative(x),
                              mx.sym.contrib.div_sqrt_dim(x)])
            z = mx.sym.ones((2,)) + mx.sym.arange(0, 2)
        vals = {"x": onp.array([[-2.0, 3.0, 1.0, -1.0]], "f")}
        got[mx] = (_eval(mx, inner, vals), _eval(mx, g, vals),
                   _eval(mx, z, {}), g.list_outputs(), y.debug_str())
    for a, b in zip(got[P][:3], got[R][:3]):
        for x, y in zip(a, b):
            onp.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    assert got[P][3:] == got[R][3:]
    assert not hasattr(P.sym.contrib, "save")
    with pytest.raises(AttributeError):
        P.sym.contrib.no_such_op


def test_visualization_summary_and_plot():
    """print_summary lists the nodes as the reference's; plot_network
    raises without graphviz as the reference's does."""
    lines = {}
    for mx in (R, P):
        with mx.name.NameManager():
            s = _mlp(mx)
        lines[mx] = [n._name for n in mx.viz.print_summary(s)]
        try:
            import graphviz  # noqa: F401
        except ImportError:
            with pytest.raises(mx.MXNetError, match="graphviz"):
                mx.viz.plot_network(s)
    assert lines[P] == lines[R]


def test_symbol_runs_on_the_current_context_only():
    """Without a card and without a CPU scope the executor's arrays have
    nowhere to go: it raises rather than falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = P.sym.Variable("data") * 2.0
    with pytest.raises(P.MXNetError):
        s.simple_bind(data=(2,))
    ex = s.simple_bind(ctx=P.cpu(), data=(2,))
    assert ex.forward()[0].context == P.cpu()
