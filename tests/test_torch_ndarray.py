"""The port's ``mx.nd`` against the JAX package's.

The same numpy inputs go through both packages' NDArray facade and op
namespace; every op the port has is held to the reference's values and,
under ``autograd.record()`` with a seeded head gradient, to its input
gradients.  The differentiable ops of ``tests/test_op_grad_battery.py``
reuse that file's inputs (its ``SPECS``); the rest are in ``EXTRA``.

Tolerances: values and gradients within rtol 1e-4, atol 1e-5 (the same
float32 functions, computed by XLA on one side and torch on the other;
transcendental ones such as ``gamma`` and ``erfinv`` differ in the last
few ulps).
"""
import os
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import ops as JOPS
from mxnet_tpu_torch.ndarray import ops as TOPS

sys.path.insert(0, os.path.dirname(__file__))
import test_op_grad_battery as battery  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _close(a, b, what):
    a, b = onp.asarray(a), onp.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    onp.testing.assert_allclose(a.astype("float64"), b.astype("float64"),
                                rtol=RTOL, atol=ATOL, err_msg=what)


def _run(pkg, call, inputs, grads=True):
    """Values of ``call(nd, *arrays)`` and, with ``grads``, the inputs'
    gradients for a seeded head gradient, in package ``pkg``."""
    xs = [pkg.nd.array(a) for a in inputs]
    if not grads:
        out = call(pkg.nd, *xs)
        return [o.asnumpy() for o in (out if isinstance(out, list)
                                      else [out])], []
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = call(pkg.nd, *xs)
    hg = onp.random.RandomState(1).uniform(0.5, 1.5, out.shape)
    out.backward(pkg.nd.array(hg.astype("float32")))
    return [out.asnumpy()], [x.grad.asnumpy() for x in xs]


def _both(call, inputs, grads=True):
    want = _run(mx, call, inputs, grads)
    with tmx.cpu():
        got = _run(tmx, call, inputs, grads)
    for kind, w, g in (("value", want[0], got[0]), ("grad", want[1], got[1])):
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(g, w)):
            _close(a, b, f"{kind} {i}")


# ------------------------------------------------------ the battery's specs

def _battery_call(name, fn):
    """``fn`` of the battery, run against package ``F`` (the ``_f``
    default of its table helpers, else its ``OPS``/``nd`` globals)."""
    def call(F, *xs):
        if "_f" in fn.__code__.co_varnames:
            return fn(*xs, _f=getattr(F.ops if F is tmx.nd else JOPS, name))
        g = fn.__globals__
        saved = g["OPS"], g["nd"]
        g["OPS"], g["nd"] = (TOPS, tmx.nd) if F is tmx.nd else (JOPS, mx.nd)
        try:
            return fn(*xs)
        finally:
            g["OPS"], g["nd"] = saved
    return call


BATTERY = sorted(n for n in battery.SPECS if n in TOPS.__all__)


@pytest.mark.parametrize("name", BATTERY)
def test_battery_op_matches_reference(name):
    fn, inputs, _tol = battery.SPECS[name]
    _both(_battery_call(name, fn), inputs)


# ------------------------------------------------------------- the others

_rs = onp.random.RandomState(3)


def R(*s):
    return _rs.uniform(-0.9, 0.9, s).astype("float32")


def I(*s, hi=3):
    return _rs.randint(0, hi, s).astype("int32")


def _idx(F, v):
    return F.array(onp.asarray(v, "int32"), dtype="int32")


# name: (call(F, *arrays), inputs, differentiable)
EXTRA = {
    "equal": (lambda F, a, b: F.equal(a, b), [I(2, 3), I(2, 3)], False),
    "not_equal": (lambda F, a, b: a != b, [I(2, 3), I(2, 3)], False),
    "greater": (lambda F, a: F.greater(a, 0.1), [R(2, 3)], False),
    "greater_equal": (lambda F, a, b: a >= b, [R(2, 3), R(2, 3)], False),
    "lesser": (lambda F, a, b: a < b, [R(2, 3), R(1, 3)], False),
    "lesser_equal": (lambda F, a: 0.2 <= a, [R(2, 3)], False),
    "logical_and": (lambda F, a, b: F.logical_and(a, b), [I(2, 3), I(2, 3)],
                    False),
    "logical_or": (lambda F, a, b: F.logical_or(a, b), [I(2, 3), I(2, 3)],
                   False),
    "logical_xor": (lambda F, a, b: F.logical_xor(a, b), [I(2, 3), I(2, 3)],
                    False),
    "logical_not": (lambda F, a: F.logical_not(a), [I(2, 3)], False),
    "isnan": (lambda F, a: F.isnan(F.log(a)), [R(2, 3)], False),
    "isinf": (lambda F, a: F.isinf(1.0 / (a * 0)), [R(2, 3)], False),
    "isfinite": (lambda F, a: F.isfinite(F.log(a)), [R(2, 3)], False),
    "floor_divide": (lambda F, a, b: a // b, [R(2, 3) * 5, R(2, 3) + 2],
                     False),
    "mod": (lambda F, a: F.mod(a, 0.3), [R(2, 3) * 3], True),
    "rmod": (lambda F, a: 2.5 % a, [R(2, 3) + 2], False),
    "rsub": (lambda F, a: 1.5 - a, [R(2, 3)], True),
    "rdiv": (lambda F, a: 1.5 / a, [R(2, 3) + 2], True),
    "rpow": (lambda F, a: 2.0 ** a, [R(2, 3)], True),
    "sign": (lambda F, a: F.sign(a), [R(2, 3)], False),
    "round": (lambda F, a: F.round(a * 4), [R(2, 3)], False),
    "rint": (lambda F, a: F.rint(a * 4), [R(2, 3)], False),
    "floor": (lambda F, a: F.floor(a * 4), [R(2, 3)], False),
    "ceil": (lambda F, a: F.ceil(a * 4), [R(2, 3)], False),
    "trunc": (lambda F, a: F.trunc(a * 4), [R(2, 3)], False),
    "fix": (lambda F, a: F.fix(a * 4), [R(2, 3)], False),
    "zeros_like": (lambda F, a: F.zeros_like(a), [R(2, 3)], False),
    "ones_like": (lambda F, a: F.ones_like(a), [R(2, 3)], False),
    "argmax": (lambda F, a: F.argmax(a, axis=1), [R(3, 4)], False),
    "argmin_all": (lambda F, a: F.argmin(a), [R(3, 4)], False),
    "topk_both": (lambda F, a: F.topk(a, k=2, ret_typ="both"), [R(3, 5)],
                  False),
    "topk_ascend": (lambda F, a: F.topk(a, k=2, axis=0, is_ascend=True),
                    [R(4, 3)], False),
    "sort_desc": (lambda F, a: F.sort(a, is_ascend=False), [R(3, 5)], False),
    "argsort_desc": (lambda F, a: F.argsort(F.round(a * 2), is_ascend=False),
                     [R(3, 5)], False),
    "argsort": (lambda F, a: F.argsort(a, axis=0), [R(3, 5)], False),
    "cast_f16": (lambda F, a: F.cast(a, dtype="float16"), [R(2, 3)], True),
    "sum_exclude": (lambda F, a: F.sum(a, axis=1, exclude=True,
                                       keepdims=True), [R(2, 3, 4)], True),
    "mean_exclude": (lambda F, a: F.mean(a, axis=0, exclude=True),
                     [R(2, 3, 4)], True),
    "mean_exclude_all": (lambda F, a: F.mean(a, axis=0, exclude=True),
                         [R(5)], True),
    "max_axis": (lambda F, a: F.max(a, axis=(0, 2)), [R(2, 3, 4)], True),
    "min_keep": (lambda F, a: F.min(a, axis=1, keepdims=True), [R(2, 3)],
                 True),
    "norm_l1": (lambda F, a: F.norm(a, ord=1, axis=1), [R(2, 3)], True),
    "dot_ta": (lambda F, a, b: F.dot(a, b, transpose_a=True),
               [R(3, 2), R(3, 4)], True),
    "batch_dot_tb": (lambda F, a, b: F.batch_dot(a, b, transpose_b=True),
                     [R(2, 3, 4), R(2, 5, 4)], True),
    "reshape_codes": (lambda F, a: F.reshape(a, shape=(0, -3, -1)),
                      [R(2, 3, 4, 2)], True),
    "reshape_split": (lambda F, a: F.reshape(a, shape=(-4, 2, -1, -2)),
                      [R(6, 4)], True),
    "transpose_axes": (lambda F, a: F.transpose(a, axes=(1, 2, 0)),
                       [R(2, 3, 4)], True),
    "split_squeeze": (lambda F, a: F.split(a, num_outputs=3, axis=1,
                                           squeeze_axis=True)[1],
                      [R(2, 3, 4)], True),
    "slice_step": (lambda F, a: F.slice(a, begin=(0, None), end=(2, 4),
                                        step=(1, 2)), [R(3, 4)], True),
    "take_wrap": (lambda F, a: F.take(a, _idx(F, [[4, -1], [1, 0]]),
                                      mode="wrap"), [R(3, 2)], True),
    "take_axis1": (lambda F, a: F.take(a, _idx(F, [2, 0]), axis=1),
                   [R(2, 3, 2)], True),
    "pick_keep": (lambda F, a: F.pick(a, _idx(F, [[1, 0, 2], [2, 2, 0]]),
                                      axis=-1, keepdims=True),
                  [R(2, 3, 3)], True),
    "one_hot": (lambda F, a: F.one_hot(_idx(F, [0, 2, 5, -1]), 3,
                                       on_value=2.0, off_value=-1.0),
                [R(1)], False),
    "tile": (lambda F, a: F.tile(a, reps=(2, 1, 2)), [R(2, 3)], True),
    "repeat_flat": (lambda F, a: F.repeat(a, repeats=2), [R(2, 3)], True),
    "flip_two": (lambda F, a: F.flip(a, axis=(0, 1)), [R(2, 3)], True),
    "pad_edge": (lambda F, a: F.pad(a, mode="edge",
                                    pad_width=(0, 0, 0, 0, 1, 2, 2, 1)),
                 [R(1, 2, 3, 3)], True),
    "pad_reflect": (lambda F, a: F.pad(a, mode="reflect",
                                       pad_width=(0, 0, 0, 0, 1, 1, 2, 1)),
                    [R(1, 2, 3, 4)], True),
    "arange_like": (lambda F, a: F.arange_like(a, start=1.0, step=0.5,
                                               axis=1), [R(2, 3)], False),
    "shape_array": (lambda F, a: F.shape_array(a), [R(2, 3)], False),
    "size_array": (lambda F, a: F.size_array(a), [R(2, 3)], False),
    "expand_squeeze": (lambda F, a: F.squeeze(F.expand_dims(a, axis=0),
                                              axis=(0, 2)),
                       [R(2, 1, 3)], True),
    "broadcast_to_zero": (lambda F, a: F.broadcast_to(a, shape=(0, 4, 3)),
                          [R(2, 1, 3)], True),
    "broadcast_add": (lambda F, a, b: F.broadcast_add(a, b),
                      [R(2, 3), R(1, 3)], True),
    "broadcast_mul_col": (lambda F, a, b: F.broadcast_mul(a, b),
                          [R(2, 3), R(2, 1)], True),
    "softmax_axis0": (lambda F, a: F.softmax(a, axis=0), [R(3, 4)], True),
    "softmax_temp": (lambda F, a: F.softmax(a, temperature=2.0), [R(3, 4)],
                     True),
    "softmax_length": (lambda F, a: F.softmax(a, length=_idx(F, [2, 4, 1]),
                                              axis=-1), [R(3, 4)], True),
    "log_softmax": (lambda F, a: F.log_softmax(a, axis=1), [R(2, 3, 4)],
                    True),
    "logsumexp_keep": (lambda F, a: F.logsumexp(a, axis=0, keepdims=True),
                       [R(3, 4)], True),
    "softmax_cross_entropy": (
        lambda F, a: F.softmax_cross_entropy(a, _idx(F, [1, 0, 3])),
        [R(3, 4)], True),
    "FullyConnected_flatten": (
        lambda F, x, w, b: F.FullyConnected(x, w, b, num_hidden=4),
        [R(2, 3, 2), R(4, 6), R(4)], True),
    "FullyConnected_last_axis": (
        lambda F, x, w: F.FullyConnected(x, w, no_bias=True, num_hidden=4,
                                         flatten=False),
        [R(2, 3, 2), R(4, 2)], True),
    "LayerNorm": (lambda F, x, g, b: F.LayerNorm(x, g, b, eps=1e-5),
                  [R(2, 3, 8), R(8) + 1, R(8)], True),
    "LayerNorm_axis1": (lambda F, x, g, b: F.LayerNorm(x, g, b, axis=1),
                        [R(2, 4, 3), R(4) + 1, R(4)], True),
    "Dropout_predict": (lambda F, a: F.Dropout(a, p=0.5), [R(2, 3)], False),
    "Dropout_zero": (lambda F, a: F.Dropout(a, p=0.0), [R(2, 3)], True),
    "gelu_erf": (lambda F, a: F.gelu(a), [R(2, 3)], True),
    "leaky_elu": (lambda F, a: F.LeakyReLU(a, act_type="elu", slope=0.3),
                  [R(2, 3)], True),
    "leaky_selu": (lambda F, a: F.LeakyReLU(a, act_type="selu"), [R(2, 3)],
                   True),
    "leaky_gelu": (lambda F, a: F.LeakyReLU(a, act_type="gelu"), [R(2, 3)],
                   True),
    "leaky_rrelu_predict": (lambda F, a: F.LeakyReLU(a, act_type="rrelu"),
                            [R(2, 3)], False),
    "BlockGrad": (lambda F, a: a * F.BlockGrad(a), [R(2, 3)], True),
    "stop_gradient": (lambda F, a: F.stop_gradient(a) + a * a, [R(2, 3)],
                      True),
    "MakeLoss": (lambda F, a: F.MakeLoss(a, grad_scale=2.0), [R(2, 3)],
                 True),
    "make_loss": (lambda F, a: F.make_loss(a), [R(2, 3)], True),
    "Cast": (lambda F, a: F.Cast(a, dtype="float32") * 2, [R(2, 3)], True),
    "concatenate": (lambda F, a, b: F.concatenate([a, b], axis=0),
                    [R(1, 3), R(2, 3)], True),
    "getitem_basic": (lambda F, a: a[1:, ::2], [R(3, 4)], True),
    "getitem_int": (lambda F, a: a[1], [R(3, 4)], True),
    "getitem_fancy": (lambda F, a: a[_idx(F, [2, 0])], [R(3, 4)], True),
    "getitem_mask": (lambda F, a: a[a > 0.1], [R(3, 4)], False),
    "neg_abs": (lambda F, a: abs(-a), [R(2, 3)], True),
    "matmul_op": (lambda F, a, b: a @ b, [R(2, 3), R(3, 2)], True),
    "method_chain": (lambda F, a: (a.reshape((3, 2)).T.exp().sum(axis=0) +
                                   a.square().mean() - a.max()),
                     [R(2, 3)], True),
    "method_ops": (lambda F, a: a.clip(-0.5, 0.5).sigmoid().log_softmax(),
                   [R(2, 3)], True),
}


# the broadcast_* names of ops whose other spellings are tested above,
# on operands that broadcast
for _name, _ins in [("broadcast_mod", [R(2, 3) * 3, R(1, 3) + 2]),
                    ("broadcast_equal", [I(2, 3), I(1, 3)]),
                    ("broadcast_not_equal", [I(2, 3), I(2, 1)]),
                    ("broadcast_greater", [R(2, 3), R(1, 3)]),
                    ("broadcast_greater_equal", [R(2, 3), R(2, 1)]),
                    ("broadcast_lesser", [R(2, 3), R(1, 3)]),
                    ("broadcast_lesser_equal", [R(2, 3), R(2, 1)]),
                    ("broadcast_logical_and", [I(2, 3), I(1, 3)]),
                    ("broadcast_logical_or", [I(2, 3), I(2, 1)]),
                    ("broadcast_logical_xor", [I(2, 3), I(1, 3)])]:
    EXTRA[_name] = (lambda F, a, b, _n=_name: getattr(F, _n)(a, b), _ins,
                    False)


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_op_matches_reference(name):
    call, inputs, grads = EXTRA[name]
    _both(call, inputs, grads)


def test_pick_and_take_clip_out_of_range_ids():
    """MXNet's ``mode='clip'``: ids past either end take the edge row.
    The reference ignores ``mode`` in ``pick`` (a jax gather wraps
    negative ids), so this is held against numpy (ROADMAP C)."""
    x = R(2, 3)
    with tmx.cpu():
        got = tmx.nd.pick(tmx.nd.array(x), _idx(tmx.nd, [5, -2]), axis=1)
        rows = tmx.nd.take(tmx.nd.array(x), _idx(tmx.nd, [7, -1]))
    onp.testing.assert_array_equal(got.asnumpy(), x[[0, 1], [2, 0]])
    onp.testing.assert_array_equal(rows.asnumpy(), x[[1, 0]])


def test_every_reference_op_is_ported_or_listed():
    """Every name of the reference's ``nd`` ops exists in the port:
    ``NOT_YET_PORTED`` is empty and stays so."""
    ref, port = set(JOPS.__all__), set(TOPS.__all__)
    missing = ref - port
    assert missing == set(), sorted(missing)
    assert TOPS.NOT_YET_PORTED == frozenset()
    for name in port & ref:
        assert hasattr(tmx.nd, name), name


# ------------------------------------------------------------- the facade

def test_array_dtypes_and_host_copies():
    """float64 becomes float32, int64 int32, lists float32 (the
    reference's rules); asnumpy returns a writable copy the caller owns."""
    cases = [onp.arange(6.0).reshape(2, 3), onp.arange(6), [1, 2, 3],
             onp.arange(4, dtype="int8"), onp.ones(3, "float16")]
    with tmx.cpu():
        for src in cases:
            t, j = tmx.nd.array(src), mx.nd.array(src)
            assert t.dtype == j.dtype and t.shape == j.shape
            a = t.asnumpy()
            a[...] = 7
            assert a.flags.writeable and not (t.asnumpy() == 7).all()
        x = tmx.nd.array([[1.5, 2.0]], dtype="int32")
        assert x.dtype == onp.int32 and x.asnumpy().tolist() == [[1, 2]]
        assert tmx.nd.array(onp.ones(2), dtype="bfloat16").dtype == "bfloat16"
        assert float(tmx.nd.array([3.5]).asscalar()) == 3.5
        assert x.context == tmx.cpu() and x.size == 2 and x.ndim == 2
        x.wait_to_read()
        tmx.nd.waitall()


def test_factories_match_reference():
    for name, args, kw in [("zeros", ((2, 3),), {}), ("ones", (4,), {}),
                           ("full", ((2, 2), 1.5), {}),
                           ("empty", ((3,),), {}),
                           ("arange", (1, 7, 2), {"repeat": 2}),
                           ("zeros", ((2,),), {"dtype": "int32"})]:
        with tmx.cpu():
            got = getattr(tmx.nd, name)(*args, **kw)
        want = getattr(mx.nd, name)(*args, **kw)
        assert got.dtype == want.dtype, name
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy(), name)


def test_views_write_through_and_rebinds_do_not():
    """``y = x[1:3]; y += 1`` changes x (MXNet's aliasing view), as does
    ``x[...] = v``; ``z = x + 0; z += 1`` does not touch x — in both
    packages."""
    def run(pkg):
        x = pkg.nd.array(onp.arange(12, dtype="float32").reshape(3, 4))
        y = x[1:3]
        y += 1
        y[0, 0] = -5.0
        z = x + 0
        z += 100
        x[2] = pkg.nd.array(onp.full(4, 9.0, "float32"))
        x[0, 1:3] = 0.5
        x[x > 10.5] = 11.0
        return x.asnumpy(), y.asnumpy(), z.asnumpy()

    want = run(mx)
    with tmx.cpu():
        got = run(tmx)
    for a, b in zip(got, want):
        onp.testing.assert_array_equal(a, b)


def test_no_context_raises_without_a_card():
    """Outside a scope the port runs on the card; on a host without one
    every way of making an array without a context raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: tmx.nd.array([1.0]), lambda: tmx.nd.zeros((2,)),
                 lambda: tmx.nd.arange(3), tmx.current_context):
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            make()
    with tmx.cpu() as ctx:
        assert tmx.current_context() == ctx == tmx.cpu(0)
        assert tmx.nd.zeros((2,)).context == tmx.cpu()
        with tmx.gpu(0):
            with pytest.raises(tmx.MXNetError, match="CUDA is not"):
                tmx.nd.zeros((2,))
        assert tmx.nd.ones((1,)).context == tmx.cpu()
    assert tmx.nd.array([1.0], ctx=tmx.cpu()).context.device_type == "cpu"


def test_save_and_load_cross_packages(tmp_path):
    data = {"w": onp.arange(6, dtype="float32").reshape(2, 3),
            "ids": onp.arange(4, dtype="int32")}
    port_file, ref_file = str(tmp_path / "port.nd"), str(tmp_path / "ref.nd")
    mx.nd.save(ref_file, {k: mx.nd.array(v) for k, v in data.items()})
    with tmx.cpu():
        tmx.nd.save(port_file, {k: tmx.nd.array(v) for k, v in data.items()})
        back = tmx.nd.load(ref_file)
    from_port = mx.nd.load(port_file)
    for k, v in data.items():
        assert back[k].dtype == v.dtype
        onp.testing.assert_array_equal(back[k].asnumpy(), v)
        onp.testing.assert_array_equal(onp.asarray(from_port[k]), v)
