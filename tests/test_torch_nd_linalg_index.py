"""The port's index and linalg ops, and two repairs, against the JAX
package's.

- ``scatter_nd`` (duplicate indices add, as the reference's
  ``.at[].add``; upstream MXNet keeps one), ``unravel_index`` (a negative
  id counts from the end, then ids clip), ``ravel_multi_index`` (each
  coordinate clipped) and ``batch_take`` (an index past the row fills
  NaN, a negative one wraps; ``pick`` and ``take`` clip instead).
- ``linalg_potrf``, ``linalg_trsm`` (all four ``transpose`` x
  ``rightside`` combinations, both triangles, ``alpha``), ``linalg_det``,
  ``linalg_slogdet`` and ``linalg_inverse``, on 8 x 8 matrices, values
  and gradients.
- ``nd.slice`` with ``None`` bounds and negative steps on two axes, and
  ``MoETransformerBlock(..., attention_dropout=0.1)``, which the
  reference builds and the port refused.

Tolerances: index outputs exact; linalg values and gradients within
rtol 1e-4, atol 1e-5 (LAPACK's and XLA's float32 factorizations, well
conditioned inputs).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import ops as TOPS

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _run(pkg, call, inputs, grad):
    xs = [pkg.nd.array(a, dtype=a.dtype) for a in inputs]
    for i in grad:
        xs[i].attach_grad()
    with pkg.autograd.record():
        out = call(pkg.nd, *xs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    if grad:
        hg = onp.random.RandomState(1).uniform(0.5, 1.5, outs[0].shape)
        outs[0].backward(pkg.nd.array(hg.astype("float32")))
    return [o.asnumpy() for o in outs], [xs[i].grad.asnumpy() for i in grad]


def _both(call, inputs, grad=(), exact=False):
    want = _run(mx, call, inputs, grad)
    with tmx.cpu():
        got = _run(tmx, call, inputs, grad)
    for kind, w, g in (("value", want[0], got[0]),
                       ("grad", want[1], got[1])):
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(g, w)):
            assert a.shape == b.shape and a.dtype == b.dtype, (kind, i)
            if exact:
                onp.testing.assert_array_equal(a, b, err_msg=f"{kind} {i}")
            else:
                onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                            err_msg=f"{kind} {i}")
    return got


# ------------------------------------------------------------------ index

def test_scatter_nd_adds_duplicates():
    rs = onp.random.RandomState(0)
    idx = onp.stack([rs.randint(0, 4, 30), rs.randint(-5, 5, 30)])
    data = rs.randn(30).astype("float32")
    got = _both(lambda nd, d, i: nd.scatter_nd(d, i, (4, 5)),
                [data, idx.astype("float32")], grad=(0,))
    want = onp.zeros((4, 5), "float32")
    onp.add.at(want, (idx[0], idx[1]), data)
    onp.testing.assert_allclose(got[0][0], want, rtol=1e-6, atol=1e-6)


def test_scatter_nd_rows():
    """Indices of the leading axis only: whole rows scattered, a
    duplicate row added."""
    idx = onp.array([[2, 0, 2]], "int32")
    _both(lambda nd, d, i: nd.scatter_nd(d, i, (3, 4)),
          [onp.arange(12, dtype="float32").reshape(3, 4), idx], grad=(0,))


def test_unravel_and_ravel_index():
    flat = onp.array([-13, -1, 0, 5, 11, 12, 100], "float32")
    _both(lambda nd, i: nd.unravel_index(i, (3, 4)), [flat], exact=True)
    coords = onp.array([[-1, 0, 2, 3, 7], [4, -2, 3, 0, 1], [0, 1, 5, 1, 0]],
                       "float32")
    _both(lambda nd, m: nd.ravel_multi_index(m, (3, 4, 2)), [coords],
          exact=True)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_batch_take_fills_past_the_row_and_wraps_negative(dtype):
    x = onp.arange(12).reshape(3, 4).astype(dtype)
    idx = onp.array([0, 7, -1], "int32")
    got = _both(lambda nd, a, i: nd.batch_take(a, i), [x, idx],
                grad=(0,) if dtype == "float32" else (), exact=True)
    if dtype == "float32":
        onp.testing.assert_array_equal(got[0][0], [0.0, onp.nan, 11.0])
    idx = onp.array([-5, 3, -4], "int32")
    _both(lambda nd, a, i: nd.batch_take(a, i), [x, idx], exact=True)


# ----------------------------------------------------------------- linalg

def _spd(seed, n=8, batch=(2,)):
    x = onp.random.RandomState(seed).randn(*batch, n, n)
    return (x @ onp.swapaxes(x, -1, -2) / n + onp.eye(n)).astype("float32")


def _tri(seed, lower, n=8):
    """A well conditioned triangle, junk in the other half (which the
    op must not read)."""
    rs = onp.random.RandomState(seed)
    a = rs.randn(2, n, n) * 0.3 + 2 * onp.eye(n)
    junk = rs.randn(2, n, n) * 100
    tri = onp.tril(a) if lower else onp.triu(a)
    keep = onp.tril(onp.ones((n, n))) if lower else onp.triu(onp.ones((n,
                                                                       n)))
    return onp.where(keep > 0, tri, junk).astype("float32")


def test_potrf():
    _both(lambda nd, a: nd.linalg_potrf(a), [_spd(0)], grad=(0,))


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("rightside", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("transpose", [False, True], ids=["n", "t"])
def test_trsm(transpose, rightside, lower):
    b = onp.random.RandomState(1).randn(2, 8, 3).astype("float32")
    if rightside:
        b = onp.swapaxes(b, -1, -2).copy()
    _both(lambda nd, a, b: nd.linalg_trsm(a, b, transpose=transpose,
                                          rightside=rightside, lower=lower,
                                          alpha=0.7),
          [_tri(0, lower), b], grad=(0, 1))


def test_det_slogdet_inverse():
    a = (onp.random.RandomState(2).randn(2, 8, 8) +
         3 * onp.eye(8)).astype("float32")
    a[1] = -a[1]                                     # a negative sign
    _both(lambda nd, a: nd.linalg_det(a), [a], grad=(0,))
    _both(lambda nd, a: nd.linalg_slogdet(a), [a], grad=(0,))
    _both(lambda nd, a: nd.linalg_slogdet(a)[1], [a], grad=(0,))
    _both(lambda nd, a: nd.linalg_inverse(a), [a], grad=(0,))


def test_linalg_runs_in_float32_under_amp():
    """The amp policy lists the linalg ops as float32 (as the
    reference's): a bf16 input is factored in float32."""
    tmx.amp.init("bfloat16")
    try:
        with tmx.cpu():
            a = tmx.nd.array(_spd(3)).astype("bfloat16")
            assert tmx.nd.linalg_potrf(a).dtype == onp.float32
            assert tmx.nd.linalg_inverse(a).dtype == onp.float32
    finally:
        tmx.amp.reset()


def test_potrf_of_an_indefinite_matrix_is_nan():
    a = -_spd(4)
    with tmx.cpu():
        got = tmx.nd.linalg_potrf(tmx.nd.array(a)).asnumpy()
    assert onp.isnan(got).all()


# ---------------------------------------------------------------- repairs

@pytest.mark.parametrize("begin,end,step", [
    ((None, None), (None, None), (1, -1)),
    ((None, None), (None, None), (-1, -1)),
    ((2, -1), (None, 0), (-1, -2)),
    ((None, 3), (0, None), (-2, -3)),
    ((-1, 1), (-4, 3), (-1, 1)),
])
def test_slice_negative_steps(begin, end, step):
    x = onp.arange(60, dtype="float32").reshape(3, 4, 5)
    got = _both(lambda nd, a: nd.slice(a, begin, end, step), [x],
                grad=(0,))
    want = x[tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))]
    onp.testing.assert_array_equal(got[0][0], want)


def test_moe_block_takes_attention_dropout():
    """The reference passes ``attention_dropout`` on to its attention;
    the port did not build the block.  In predict mode both give the
    same output from the same weights; in training the attention takes
    the reference path, which drops weights."""
    from mxnet_tpu.models.moe import MoETransformerBlock as JBlock
    from mxnet_tpu_torch.models import moe as tmoe
    from mxnet_tpu_torch.ops import attention
    from mxnet_tpu_torch.utils.convert import load_numpy_params

    x = onp.random.RandomState(0).randn(2, 5, 16).astype("float32")
    jblk = JBlock(16, 32, 2, 4, attention_dropout=0.1)
    jblk.initialize(mx.init.Normal(0.2))
    want = jblk(mx.nd.array(x)).asnumpy()
    tblk = tmoe.MoETransformerBlock(16, 32, 2, 4, attention_dropout=0.1)
    assert tblk.attn._att_dropout == 0.1
    load_numpy_params(tblk, {
        k: p.data().asnumpy()
        for k, p in jblk._collect_params_with_prefix().items()},
        device="cpu")
    with torch.no_grad():
        got = tblk(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    seen = []
    orig = attention._attention_ref

    def spy(*a, **kw):
        seen.append(kw.get("dropout"))
        return orig(*a, **kw)
    attention._attention_ref = spy
    try:
        with tmx.base.training_mode(True):
            tblk(torch.from_numpy(x))
    finally:
        attention._attention_ref = orig
    assert seen == [0.1]


def test_the_new_ops_are_on_nd():
    """The 37 ops of this family, each in the port's ``ops.__all__`` and
    on ``nd`` under the reference's name."""
    from mxnet_tpu.ndarray import ops as JOPS
    from mxnet_tpu_torch.ndarray import detection, sampling
    names = set(sampling.__all__) | set(detection.__all__) | {
        "scatter_nd", "unravel_index", "ravel_multi_index", "batch_take",
        "linalg_potrf", "linalg_trsm", "linalg_det", "linalg_slogdet",
        "linalg_inverse"}
    assert len(names) == 37 and names <= set(JOPS.__all__)
    assert names <= set(TOPS.__all__)
    for name in names:
        assert getattr(tmx.nd, name) is getattr(TOPS, name), name
