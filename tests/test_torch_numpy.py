"""``mx.np`` / ``mx.npx`` of the port against the JAX package's, on the
CPU, and the runtime modules (``util``, ``test_utils``, ``runtime``,
``engine``, ``rtc``).

The op table is ``tools/np_cases.py``: one case per name of the
reference's tables (``_SIMPLE_OPS``, the creation functions,
``linalg``'s 21 names), each run by both packages on the same seeded
numpy inputs and held at the case's tolerance (float32 round-off:
1e-5 to 1e-4 relative; the decompositions 1e-4 to 1e-3), with the
reference's dtypes.  The host-side type utilities, whose reference
wrapper raises, and the variants of a name (a keyword, an axis) are
held to numpy's values.  A sample of differentiable ops is held to the
reference's gradients (1e-4).  ``np.random`` is held to the
reference's laws (each sample mean within five standard errors of the
law's), shapes and dtypes, and to ``seed``'s repeatability; its bits
differ (Philox against threefry).
"""
import os
import sys
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as R
import mxnet_tpu_torch as P

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import np_cases as C  # noqa: E402

CASES = C.cases()
BASE = [c for c in CASES if not c.tag or c.oracle == "numpy"
        or c.name in ("partition", "argpartition")]
VARIANTS = [c for c in CASES if c not in BASE]


@pytest.fixture(autouse=True)
def _on_cpu():
    with P.cpu():
        yield


def _ref_wrap(a):
    return R.np.array(a, dtype=a.dtype)


def _port_wrap(a):
    return P.np.array(a, dtype=a.dtype)


def test_every_name_of_the_reference_tables_is_ported():
    skip = {"linalg", "random"}
    names = [n for n in R.np.__all__ if hasattr(R.np, n) and n not in skip]
    assert [n for n in names if not hasattr(P.np, n)] == []
    assert sorted(P.np.linalg.__all__) == sorted(R.np.linalg.__all__)
    assert sorted(P.np.random.__all__) == sorted(R.np.random.__all__)
    assert [n for n in R.npx.__all__ if not hasattr(P.npx, n)] == []
    # every callable name has a case in the table
    covered = {c.name for c in CASES}
    ops = [n for n in names if callable(getattr(R.np, n)) and
           n not in ("ndarray", "dtype", "may_share_memory",
                     "shares_memory")]
    assert [n for n in ops if n not in covered] == []
    assert [n for n in R.np.linalg.__all__
            if f"linalg.{n}" not in covered] == []


@pytest.mark.parametrize("case", BASE, ids=[c.id for c in BASE])
def test_op_matches_the_reference(case):
    if case.oracle == "numpy":
        want = C.run(case, onp, lambda a: a)
    else:
        want = C.run(case, R.np, _ref_wrap)
    got = C.run(case, P.np, _port_wrap)
    assert got[0] == "ok", got
    diff = C.agree(case, want, got, dtypes=case.oracle != "numpy")
    assert diff is None, diff


@pytest.mark.parametrize("case", VARIANTS, ids=[c.id for c in VARIANTS])
def test_op_variant_matches_numpy(case):
    want = C.run(case, onp, lambda a: a)
    got = C.run(case, P.np, _port_wrap)
    diff = C.agree(case, want, got, dtypes=False)
    assert diff is None, diff


def _grads(mod, wrap, case):
    fn = C.resolve(case.name, mod.np)
    arrays = []

    def make(a):
        x = wrap(a)
        if a.dtype.kind == "f":
            x.attach_grad()
            arrays.append(x)
        return x

    args = C._args(case.args, mod.np, make)
    kwargs = C._args(case.kwargs, mod.np, make)
    with mod.autograd.record():
        out = fn(*args, **kwargs)
        out = out[0] if isinstance(out, (list, tuple)) else out
        head = (out * out).sum()
    head.backward()
    return [x.grad.asnumpy() for x in arrays]


GRAD = [c for c in CASES if c.grad]


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_the_reference(case):
    got = _grads(P, _port_wrap, case)
    want = _grads(R, _ref_wrap, case)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_recording_follows_the_reference_nondiff_table():
    """An op records a graph exactly where the reference's ``_NONDIFF``
    does not name it."""
    np = P.np
    assert P.np._NONDIFF == R.np._NONDIFF
    x = np.array(onp.arange(1.0, 7.0, dtype="float32").reshape(2, 3))
    x.attach_grad()
    with P.autograd.record():
        for name in ("exp", "sum", "sort", "matmul", "floor", "argmax",
                     "equal", "sign"):
            fn = getattr(np, name)
            out = fn(x, x.T) if name == "matmul" else (
                fn(x, x) if name == "equal" else fn(x))
            assert out.tensor.requires_grad == (
                name not in R.np._NONDIFF), name


def test_amp_casts_np_ops_as_nd_ops():
    """Under ``amp.init('bfloat16')`` an np op is cast by its name's
    policy, as the reference casts it."""
    a = onp.random.RandomState(0).randn(4, 4).astype("float32")
    for mx in (P, R):
        mx.amp.init("bfloat16")
    try:
        for name in ("matmul", "dot", "exp", "sum"):
            got = getattr(P.np, name)(*([P.np.array(a)] * (
                2 if name in ("matmul", "dot") else 1)))
            want = getattr(R.np, name)(*([R.np.array(a)] * (
                2 if name in ("matmul", "dot") else 1)))
            assert str(got.dtype) == str(want.dtype), name
    finally:
        for mx in (P, R):
            mx.amp.reset()


def test_out_and_scalar_mixes():
    np = P.np
    a = np.ones((2, 3))
    onp.testing.assert_array_equal(np.add(a, 2.0).asnumpy(),
                                   onp.full((2, 3), 3.0))
    onp.testing.assert_array_equal(np.multiply(3.0, a).asnumpy(),
                                   onp.full((2, 3), 3.0))
    out = np.zeros((2, 3))
    r = np.add(a, a, out=out)
    assert r is out and out.asnumpy().sum() == 12
    assert np.add(1, 2).asnumpy() == 3
    assert isinstance(np.ndarray, type) and np.ndarray is P.nd.NDArray
    assert np.pi == R.np.pi and np.float32 is R.np.float32


def test_autograd_through_np_ops():
    np = P.np
    x = np.array([[1.0, 2.0], [3.0, 4.0]])
    x.attach_grad()
    with P.autograd.record():
        y = np.sum(np.multiply(x, x))
    y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy())
    z = np.array(onp.random.RandomState(5).randn(3, 3).astype("f"))
    z.attach_grad()
    with P.autograd.record():
        np.einsum("ij->", np.exp(z)).backward()
    onp.testing.assert_allclose(z.grad.asnumpy(), onp.exp(z.asnumpy()),
                                rtol=1e-5)


def test_callable_ops_record_the_users_function():
    np = P.np
    x = np.array(onp.random.RandomState(1).randn(3, 4).astype("f"))
    x.attach_grad()
    with P.autograd.record():
        y = np.apply_along_axis(lambda r: np.sum(r * r), 1, x)
        y.sum().backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy(),
                                rtol=1e-6)


# ------------------------------------------------------------ np.random

N = 20000


def _law(name, args, mean, var):
    return pytest.param(name, args, mean, var, id=name)


LAWS = [
    _law("uniform", (2.0, 5.0), 3.5, 0.75),
    _law("normal", (1.0, 2.0), 1.0, 4.0),
    _law("randint", (0, 10), 4.5, 8.25),
    _law("gamma", (2.0, 3.0), 6.0, 18.0),
    _law("beta", (2.0, 3.0), 0.4, 0.04),
    _law("exponential", (2.0,), 2.0, 4.0),
    _law("poisson", (3.0,), 3.0, 3.0),
    _law("lognormal", (0.0, 0.5), onp.exp(0.125),
         (onp.exp(0.25) - 1) * onp.exp(0.25)),
    _law("laplace", (1.0, 2.0), 1.0, 8.0),
    _law("gumbel", (0.0, 1.0), 0.5772156649, onp.pi ** 2 / 6),
    _law("logistic", (0.0, 1.0), 0.0, onp.pi ** 2 / 3),
    _law("chisquare", (4.0,), 4.0, 8.0),
    _law("binomial", (10, 0.3), 3.0, 2.1),
    _law("bernoulli", (0.3,), 0.3, 0.21),
    _law("weibull", (2.0,), 0.8862269255, 1 - 0.8862269255 ** 2),
    _law("pareto", (5.0,), 1.25, 5.0 / (16 * 3)),
    _law("power", (3.0,), 0.75, 3.0 / 80),
    _law("rayleigh", (2.0,), 2.0 * onp.sqrt(onp.pi / 2),
         (4 - onp.pi) / 2 * 4),   # the reference's raises (below)
    _law("f", (5.0, 10.0), 1.25, 2 * 100 * 13 / (5 * 64 * 6)),
    _law("standard_normal", (), 0.0, 1.0),
    _law("standard_exponential", (), 1.0, 1.0),
    _law("negative_binomial", (5, 0.5), 5.0, 10.0),
]


def _draw(mod, name, args, size):
    return getattr(mod.np.random, name)(*args, size=size)


@pytest.mark.parametrize("name,args,mean,var", LAWS)
def test_random_law_shape_dtype_and_seed(name, args, mean, var):
    """Both packages' samples have the law's mean (five standard
    errors), the reference's shape and dtype, and a seed repeats the
    port's stream."""
    P.np.random.seed(3)
    a = _draw(P, name, args, (N,))
    tol = 5 * onp.sqrt(var / N)
    assert abs(float(a.asnumpy().astype("f8").mean()) - mean) < tol, name
    if name == "rayleigh":
        # the reference hands its shape to jax's rayleigh as the scale
        # and raises at any size; the port draws the law its name gives
        with pytest.raises(Exception):
            _draw(R, name, args, (2, 3))
        assert _draw(P, name, args, (2, 3)).dtype == onp.float32
        return
    R.np.random.seed(3)
    want = _draw(R, name, args, (N,))
    assert str(a.dtype) == str(want.dtype), name
    assert abs(float(want.asnumpy().astype("f8").mean()) - mean) < tol, name
    assert _draw(P, name, args, (2, 3)).shape == (2, 3)
    P.np.random.seed(11)
    x = _draw(P, name, args, (50,)).asnumpy()
    P.np.random.seed(11)
    onp.testing.assert_array_equal(x, _draw(P, name, args,
                                            (50,)).asnumpy())


def test_random_the_rest():
    np = P.np
    np.random.seed(1)
    x = np.arange(10)
    np.random.shuffle(x)
    assert sorted(x.asnumpy().tolist()) == list(range(10))
    c = np.random.choice(5, size=(2000,), p=[0.1, 0.2, 0.3, 0.2, 0.2])
    freq = onp.bincount(c.asnumpy(), minlength=5) / 2000
    assert onp.abs(freq - [0.1, 0.2, 0.3, 0.2, 0.2]).max() < 0.05
    assert sorted(np.random.choice(8, size=(8,), replace=False)
                  .asnumpy().tolist()) == list(range(8))
    assert sorted(np.random.permutation(7).asnumpy().tolist()) == \
        list(range(7))
    m = np.random.multinomial(10, [0.2, 0.3, 0.5], size=(4000,)).asnumpy()
    assert m.shape == (4000, 3) and (m.sum(1) == 10).all()
    onp.testing.assert_allclose(m.mean(0), [2, 3, 5], atol=0.1)
    mv = np.random.multivariate_normal(
        onp.array([1.0, 2.0]), onp.array([[1.0, 0.5], [0.5, 2.0]]),
        size=(N,)).asnumpy()
    onp.testing.assert_allclose(onp.cov(mv.T), [[1, 0.5], [0.5, 2]],
                                atol=0.1)
    cy = np.random.standard_cauchy((N,)).asnumpy()
    assert abs(onp.median(cy)) < 0.05
    assert np.random.rand(2, 3).shape == np.random.randn(2, 3).shape
    u = np.zeros((3,))
    np.random.uniform(size=(3,), out=u)
    assert (u.asnumpy() > 0).all()
    a = np.random.normal(np.array(onp.zeros(4, "f")), 1.0)
    assert a.shape == (4,)


# ----------------------------------------------------------------- npx

def test_npx_delegates_to_the_nd_ops():
    for name in R.npx._DELEGATED:
        target = R.npx._ALIAS_TO_ND.get(name, name)
        assert getattr(P.npx, name) is getattr(P.nd, target), name
    x = onp.array([[-1.0, 2.0], [0.5, -3.0]], "float32")
    onp.testing.assert_array_equal(P.npx.relu(P.np.array(x)).asnumpy(),
                                   onp.maximum(x, 0))
    oh = P.npx.one_hot(P.np.array([0, 2], dtype="int32"), 3).asnumpy()
    onp.testing.assert_array_equal(oh, onp.eye(3)[[0, 2]])


@pytest.mark.parametrize("log", [False, True])
def test_npx_masked_softmax_matches_the_reference(log):
    x = onp.array([[1.0, 2.0, 3.0], [1.0, 1.0, 1.0]], "float32")
    m = onp.array([[1, 1, 0], [0, 0, 0]], "float32")
    fn = "masked_log_softmax" if log else "masked_softmax"
    got = getattr(P.npx, fn)(P.np.array(x), P.np.array(m),
                             temperature=2.0).asnumpy()
    want = getattr(R.npx, fn)(R.np.array(x), R.np.array(m),
                              temperature=2.0).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-6)
    xa = P.np.array(x[:1])
    xa.attach_grad()
    with P.autograd.record():
        y = P.npx.masked_softmax(xa, P.np.array(m[:1]))
        (y * y).sum().backward()
    g = xa.grad.asnumpy()
    assert onp.isfinite(g).all() and g[0, 2] == 0.0


@pytest.mark.parametrize("newshape,reverse", [
    ((-2, -1), False), ((-3, -1), False), ((-4,), False), ((-5, -1), False),
    ((-6, 2, -1, -4), False), ((2, -1), True), ((0, -1), False)])
def test_npx_reshape_codes_match_the_reference(newshape, reverse):
    shape = (1, 4, 6) if -3 in newshape else (4, 6, 2)
    if 0 in newshape:
        shape = (0, 3)
    x = onp.arange(int(onp.prod(shape)), dtype="float32").reshape(shape)
    got = P.npx.reshape(P.np.array(x), newshape, reverse=reverse)
    want = R.npx.reshape(R.np.array(x), newshape, reverse=reverse)
    assert got.shape == want.shape
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_npx_nonzero_seed_save_load(tmp_path):
    x = onp.array([[0, 1], [2, 0]], "float32")
    got = P.npx.nonzero(P.np.array(x)).asnumpy()
    onp.testing.assert_array_equal(got,
                                   R.npx.nonzero(R.np.array(x)).asnumpy())
    assert got.dtype == onp.int64
    P.npx.seed(5)
    a = P.np.random.uniform(size=(3,)).asnumpy()
    P.npx.seed(5)
    onp.testing.assert_array_equal(a, P.np.random.uniform(
        size=(3,)).asnumpy())
    f = str(tmp_path / "a.params")
    P.npx.save(f, {"a": P.np.array(x)})
    onp.testing.assert_array_equal(P.npx.load(f)["a"].asnumpy(), x)
    P.npx.waitall()
    assert P.npx.current_device() == P.cpu()


def test_np_state_scopes_are_per_thread():
    npx = P.npx
    assert not npx.is_np_array()
    npx.set_np()
    assert npx.is_np_array() and npx.is_np_shape()
    seen = []
    t = threading.Thread(target=lambda: seen.append(npx.is_np_array()))
    t.start()
    t.join()
    assert seen == [False]
    npx.reset_np()
    assert not npx.is_np_array()

    @npx.use_np
    def inner():
        return npx.is_np_array()
    assert inner() and not npx.is_np_array()
    with npx.np_shape(True):
        assert npx.is_np_shape() and not npx.is_np_array()
    with npx.np_array(True):
        assert npx.is_np_array()
    assert not npx.is_np_default_dtype()


# ---------------------------------------------------- the runtime modules

def test_util_delegates_and_disable_jit():
    util = P.util
    assert not util.is_np_array()
    util.set_np()
    try:
        assert util.is_np_array() and util.is_np_shape()
        a = util.default_array([1, 2])
        assert a.dtype == onp.int32            # np's rules
    finally:
        util.reset_np()
    assert util.default_array([1, 2]).dtype == onp.float32   # nd's
    assert util.get_gpu_count() == P.context.num_gpus()
    assert util.get_gpu_memory(99) == (0, 0)
    util.setenv("MXNET_PORT_TEST_VAR", "7")
    assert util.getenv("MXNET_PORT_TEST_VAR") == "7"
    del os.environ["MXNET_PORT_TEST_VAR"]
    # disable_jit runs a hybridized block imperatively: no program is
    # built while it is off
    net = P.gluon.nn.Dense(3, in_units=4)
    net.initialize()
    net.hybridize()
    x = P.nd.array(onp.ones((2, 4), "f"))
    with util.disable_jit():
        y0 = net(x).asnumpy()
        assert net._cached_op is None
    y1 = net(x).asnumpy()
    assert net._cached_op is not None
    onp.testing.assert_allclose(y0, y1, rtol=1e-6)
    util.disable_jit()
    assert not P.utils.graphs.compile_enabled()
    util.enable_jit()
    assert P.utils.graphs.compile_enabled()


def test_test_utils_helpers(tmp_path):
    tu = P.test_utils
    assert tu.default_rtol("float16") == R.test_utils.default_rtol(
        "float16")
    assert tu.default_atol("bfloat16") == 2e-2
    tu.assert_almost_equal(onp.ones(3), onp.ones(3) + 1e-7)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(onp.ones(3), onp.ones(3) + 1e-2)
    assert tu.same(P.nd.array([1, 2]), onp.array([1, 2]))
    onp.random.seed(0)
    r = tu.rand_ndarray((3, 4), scale=2.0)
    assert r.shape == (3, 4) and float(abs(r.asnumpy()).max()) <= 2.0
    assert len(tu.rand_shape_nd(3)) == 3
    tu.check_numeric_gradient(lambda a, b: (a * b * b).sum(),
                              [onp.random.rand(2, 3), onp.random.rand(2, 3)],
                              eps=1e-2)
    res = tu.check_consistency(lambda a: P.nd.tanh(a) * 2,
                               [onp.random.rand(3, 3)],
                               dtypes=["float32", "float16"])
    assert len(res) == 2
    assert tu.list_gpus() == list(range(P.context.num_gpus()))
    assert tu.mesh_devices(1 + torch.cuda.device_count()) is None
    assert tu.default_context() == P.cpu()
    f = tmp_path / "here.bin"
    f.write_bytes(b"x")
    assert tu.download("http://example.invalid/here.bin",
                       dirname=str(tmp_path)) == str(f)
    with pytest.raises(P.MXNetError):
        tu.download("http://example.invalid/absent.bin",
                    dirname=str(tmp_path))
    m = tu.get_mnist()
    assert m["train_data"].shape[1:] == (1, 28, 28)
    onp.testing.assert_array_equal(m["test_label"],
                                   R.test_utils.get_mnist()["test_label"])

    @tu.with_seed(4)
    def drawn():
        return onp.random.rand(), P.random.host_rng().rand()
    assert drawn() == drawn()


def test_runtime_engine_rtc():
    feats = P.runtime.Features()
    assert list(feats) == list(R.runtime.Features())
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    assert not feats.is_enabled("TPU") and not feats.is_enabled("PALLAS")
    assert [f.name for f in P.runtime.feature_list()] == list(feats)
    eng = P.engine
    prev = eng.set_bulk_size(30)
    with eng.bulk(5):
        assert eng.set_bulk_size(5) == 5
    assert eng.set_bulk_size(prev) == 30
    for cls in (P.rtc.CudaModule, P.rtc.CudaKernel):
        with pytest.raises(P.MXNetError, match="csrc"):
            cls("extern \"C\" __global__ void k() {}")
