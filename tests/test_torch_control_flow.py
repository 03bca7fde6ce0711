"""The port's ``contrib`` control flow, ``operator`` / ``nd.Custom``,
``library`` and ``profiler`` against the JAX package's, on the CPU.

Control flow runs eagerly (a Python loop, the predicate read on the
host) and inside a program (a hybridized block's CachedOp, which on the
CPU runs the same function a CUDA graph would capture: ``while_loop``
with an active flag, ``cond`` computing both branches), each against the
reference's same case; values and gradients at 1e-6 (float32, the same
few operations).  A branch not taken that is non-finite must leave the
result and the gradient finite.
"""
import json
import os

import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu import contrib as RC
from mxnet_tpu_torch import contrib as PC

TOL = 1e-6


def _both(fn, *xs, grad=False):
    """``fn(mx, *arrays)`` in both packages on the same numpy inputs;
    with ``grad``, also the gradient of ``sum(out)`` to each input.
    Returns ((ref values, ref grads), (port values, port grads))."""
    out = []
    for mx, scope in ((R, None), (P, P.cpu())):
        if scope is not None:
            scope.__enter__()
        try:
            arrs = [mx.nd.array(x) for x in xs]
            for a in arrs if grad else ():
                a.attach_grad()
            with mx.autograd.record():
                y = fn(mx, *arrs)
                ys = y if isinstance(y, (list, tuple)) else [y]
                head = sum(mx.nd.sum(v) for v in ys)
            if grad:
                head.backward()
            out.append(([v.asnumpy() for v in ys],
                        [a.grad.asnumpy() for a in arrs] if grad else []))
        finally:
            if scope is not None:
                scope.__exit__(None, None, None)
    return out


def _agree(pair):
    (rv, rg), (pv, pg) = pair
    for a, b in zip(pv + pg, rv + rg):
        assert onp.isfinite(a).all()
        onp.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def _hybrid(mx, fn):
    """A hybridized block whose ``hybrid_forward`` is ``fn(F, x)``."""
    class Net(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return fn(F, x)

    class RefNet(mx.gluon.HybridBlock):
        def forward(self, x):
            return fn(mx.nd, x)

    net = (RefNet if mx is R else Net)()
    net.hybridize()
    return net


def _contrib(mx):
    return RC if mx is R else PC


def _foreach(mx, F, x, w=None):
    def body(item, st):
        new = st + item * (w if w is not None else 1.0)
        return new * 2.0, new
    outs, final = _contrib(mx).foreach(body, x, F.zeros((x.shape[1],)))
    return [outs, final]


def _while(mx, F, x):
    outs, (i, s) = _contrib(mx).while_loop(
        lambda i, s: F.sum(i) < 4.0,
        lambda i, s: (s * i + 1.0, (i + 1.0, s + i * x)),
        (F.zeros((1,)), x), max_iterations=6)
    return [outs, i, s]


def _cond(mx, F, x):
    # each branch is NaN in value and derivative (the square root of a
    # negative) where it is not taken
    return _contrib(mx).cond(F.sum(x) > 2.0, lambda: F.sqrt(x - 1.0) * 3.0,
                             lambda: F.sqrt(1.0 - x) + x)


CASES = {"foreach": _foreach, "while_loop": _while, "cond": _cond}
INPUTS = {"foreach": [onp.arange(12, dtype="f").reshape(4, 3) / 4,
                      onp.ones((4, 3), "f") * -2],
          "while_loop": [onp.array([0.5], "f"), onp.array([-1.5], "f")],
          "cond": [onp.array([2.0, 1.5], "f"), onp.array([0.5, -0.25], "f")]}


@pytest.mark.parametrize("mode", ["eager", "program"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_control_flow_values_and_grads_equal_the_reference(name, mode):
    """Each op, eagerly and inside a hybridized block, on two inputs (the
    second down the other path: the program is reused), values and
    gradients against the reference's."""
    fn = CASES[name]
    nets = {}

    def run(mx, x):
        if mode == "eager":
            return fn(mx, mx.nd, x)
        if mx not in nets:
            nets[mx] = _hybrid(mx, lambda F, v: fn(mx, F, v))
        return nets[mx](x)

    for x in INPUTS[name]:
        _agree(_both(run, x, grad=True))


def test_foreach_closure_gradient_equals_the_reference():
    """``foreach``'s gradient to an array the body closes over."""
    data = onp.ones((3, 2), "f")

    def fn(mx, w):
        return _foreach(mx, mx.nd, mx.nd.array(data), w)[1]
    _agree(_both(fn, onp.array([2.0, 3.0], "f"), grad=True))


def test_program_cond_keeps_the_branch_not_taken_out_of_the_gradient():
    """In a program both branches run; the one not taken is NaN in value
    and derivative, and the result and gradient stay those of the eager
    (one-branch) run.  The program's second call takes the other path."""
    with P.cpu():
        net = _hybrid(P, lambda F, v: _cond(P, F, v))
        for v in ([2.0, 1.5], [0.5, -0.25]):
            got, want = [], []
            for run in (net, lambda x: _cond(P, P.nd, x)):
                x = P.nd.array(onp.array(v, "f"))
                x.attach_grad()
                with P.autograd.record():
                    y = run(x)
                y.backward()
                (got if run is net else want).append(
                    (y.asnumpy(), x.grad.asnumpy()))
            for a, b in zip(got[0], want[0]):
                assert onp.isfinite(a).all()
                onp.testing.assert_array_equal(a, b)
        assert net._cached_op is not None


def test_while_loop_needs_max_iterations_and_pads_with_zeros():
    with P.cpu():
        with pytest.raises(P.MXNetError):
            PC.while_loop(lambda i: i < 2, lambda i: (i, i + 1),
                          P.nd.array([0.0]))
        outs, final = PC.while_loop(lambda i: i < 2, lambda i: (i * 10, i + 1),
                                    P.nd.array([0.0]), max_iterations=5)
    ref_outs, ref_final = RC.while_loop(
        lambda i: i < 2, lambda i: (i * 10, i + 1), R.nd.array([0.0]),
        max_iterations=5)
    onp.testing.assert_array_equal(outs.asnumpy(), ref_outs.asnumpy())
    onp.testing.assert_array_equal(final.asnumpy(), ref_final.asnumpy())


def test_contrib_namespaces():
    """``mx.contrib`` and ``mx.nd.contrib`` resolve lazily to the module,
    which forwards registered op names to ``nd``."""
    assert P.contrib is PC and P.nd.contrib is PC
    assert PC.foreach is P.nd.contrib.foreach
    assert PC.softmax is P.nd.softmax
    with pytest.raises(AttributeError):
        PC.no_such_op


def _custom_ops(mx, tag):
    """The reference's test custom op (a host-side sigmoid with a
    backward), registered in package ``mx`` as ``tag``."""
    mo = mx.operator
    nd = mx.nd

    class Sigmoid(mo.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], nd.array(1.0 / (1.0 + onp.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            gy = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], nd.array(gy * y * (1 - y)))

    @mo.register(tag)
    class SigmoidProp(mo.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()


def test_custom_op_values_and_grads_equal_the_reference():
    _custom_ops(R, "cf_sigmoid")
    _custom_ops(P, "cf_sigmoid")
    x = onp.array([0.0, 1.0, -1.0, 3.0], "f")
    pair = _both(lambda mx, a: mx.nd.Custom(a * 2.0, op_type="cf_sigmoid"),
                 x, grad=True)
    _agree(pair)
    sig = 1 / (1 + onp.exp(-2 * x))
    onp.testing.assert_allclose(pair[1][1][0], 2 * sig * (1 - sig),
                                rtol=1e-5)
    with P.cpu():
        y = P.nd.Custom(P.nd.array(x), op_type="cf_sigmoid")  # unrecorded
        assert y.shape == (4,) and not y._t.requires_grad
        with pytest.raises(P.MXNetError):
            P.nd.Custom(P.nd.array(x), op_type="no_such_custom_op")


def test_custom_op_runs_inside_a_cpu_program():
    """On the CPU a hybridized block's program runs its function as is,
    so a custom op whose body reads the host runs there (on the card the
    capture refuses it; ``tests/test_torch_cuda.py``)."""
    _custom_ops(P, "cf_sigmoid_prog")
    with P.cpu():
        net = _hybrid(P, lambda F, v: F.Custom(v, op_type="cf_sigmoid_prog")
                      + 1.0)
        x = P.nd.array(onp.array([0.0, 2.0], "f"))
        x.attach_grad()
        with P.autograd.record():
            y = net(x)
        y.backward()
    sig = 1 / (1 + onp.exp(-onp.array([0.0, 2.0])))
    onp.testing.assert_allclose(y.asnumpy(), sig + 1.0, rtol=1e-6)
    onp.testing.assert_allclose(x.grad.asnumpy(), sig * (1 - sig), rtol=1e-5)


_EXT = '''import {pkg}.operator as mo


class Double(mo.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] * 2.0)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0] * 2.0)


@mo.register("{name}")
class DoubleProp(mo.CustomOpProp):
    def create_operator(self, ctx, shapes, dtypes):
        return Double()
'''


def test_library_loads_a_python_extension(tmp_path):
    """The reference's extension (written for each package) loads, its
    op runs with a gradient; loading twice returns the same module; an
    unknown kind or a missing file raises."""
    for mx, pkg in ((R, "mxnet_tpu"), (P, "mxnet_tpu_torch")):
        ext = tmp_path / f"ext_{pkg}.py"
        ext.write_text(_EXT.format(pkg=pkg, name="cf_ext_double"))
        mod = mx.library.load(str(ext))
        assert mx.library.load(str(ext)) is mod
    _agree(_both(lambda mx, a: mx.nd.Custom(a, op_type="cf_ext_double"),
                 onp.array([3.0, -1.0], "f"), grad=True))
    bad = tmp_path / "ext.txt"
    bad.write_text("")
    for path in (bad, tmp_path / "missing.py"):
        with pytest.raises(P.MXNetError):
            P.library.load(str(path))
    assert isinstance(P.library.compiled_with_cxx11_abi(), bool)


def test_profiler_round_trip(tmp_path):
    """The reference's round trip: ``set_config``, ``run``, a range,
    ``stop``, ``dump`` names a directory derived from the filename and
    holding a Chrome trace that names the ``Task`` range; ``pause`` and
    ``resume`` write a second trace; a second active session raises."""
    import torch
    f = str(tmp_path / "prof.json")
    P.profiler.set_config(filename=f, profile_all=True)
    with P.cpu():
        P.profiler.set_state("run")
        with P.profiler.Task("bench_range"), P.profiler.Frame("frame"):
            a = P.nd.array(onp.ones((64, 64), "float32"))
            P.nd.dot(a, a).wait_to_read()
        P.profiler.pause()
        P.profiler.resume()
        P.profiler.set_state("stop")
    d = P.profiler.dump()
    assert d == str(tmp_path / "prof_torch_profile") and os.path.isdir(d)
    assert sorted(os.listdir(d)) == ["trace-0.json", "trace-1.json"]
    with open(os.path.join(d, "trace-0.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"bench_range", "frame"} <= names
    assert "Profile data" in P.profiler.dumps() and "2 files" in \
        P.profiler.dumps()
    with torch.profiler.profile():
        with pytest.raises(P.MXNetError, match="another torch.profiler"):
            P.profiler.set_state("run")
