"""The port's 18 random samplers held to the reference's contracts.

Philox (the port's generator) cannot give threefry's (the reference's)
bits, so no draw is compared with the reference's.  What is held:

- shape and dtype equal to the reference's for the same call (``shape``
  None, an int or a tuple; float64 and int64 narrowed);
- one seed repeats a stream bit for bit, another seed differs, and the
  draws come from the port's generator, not torch's global one;
- the distribution: 2**16 draws' mean and variance within 6 sigma / sqrt(n)
  of scipy.stats' values, and a goodness-of-fit test (Kolmogorov-Smirnov
  for continuous laws, chi-square over cells of expected count >= 20 for
  discrete ones) at p > 1e-4;
- the reference's surface quirks: positional parameters dropped,
  ``out=`` rebinding, the current context as the default ``ctx``,
  ``sample_multinomial``'s ``shape=1`` and ``get_prob`` (the
  reference's formula at the port's draws).
"""
import numpy as onp
import pytest
import scipy.stats as st
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

torch.set_num_threads(1)

N = 1 << 16

# name: (kwargs, scipy law, discrete)
LAWS = {
    "random_uniform": (dict(low=-1.0, high=3.0), st.uniform(-1, 4), False),
    "uniform": (dict(low=2.0, high=2.5), st.uniform(2, 0.5), False),
    "random_normal": (dict(loc=1.0, scale=2.0), st.norm(1, 2), False),
    "normal": (dict(loc=-3.0, scale=0.5), st.norm(-3, 0.5), False),
    "random_gamma": (dict(alpha=2.5, beta=1.5), st.gamma(2.5, scale=1.5),
                     False),
    "random_exponential": (dict(lam=2.0), st.expon(scale=0.5), False),
    "random_poisson": (dict(lam=3.5), st.poisson(3.5), True),
    "random_randint": (dict(low=-3, high=5), st.randint(-3, 5), True),
    "random_negative_binomial": (dict(k=3, p=0.4), st.nbinom(3, 0.4), True),
    "random_generalized_negative_binomial": (
        dict(mu=2.0, alpha=0.5), st.nbinom(2.0, 0.5), True),
}
# the per-distribution samplers: parameter arrays (2,), the law of row 0
PARAM_LAWS = {
    "sample_uniform": ([[0.0, 5.0], [2.0, 6.0]], st.uniform(0, 2), False),
    "sample_normal": ([[1.0, -1.0], [3.0, 0.1]], st.norm(1, 3), False),
    "sample_gamma": ([[0.7, 4.0], [2.0, 1.0]], st.gamma(0.7, scale=2.0),
                     False),
    "sample_exponential": ([[0.5, 4.0]], st.expon(scale=2.0), False),
    "sample_poisson": ([[6.0, 0.5]], st.poisson(6.0), True),
}


def _moments_and_fit(x, law, discrete, what):
    x = onp.asarray(x, "float64").ravel()
    n = x.size
    mean, var, _skew, kurt = (float(v) for v in law.stats(moments="mvsk"))
    assert abs(x.mean() - mean) < 6 * (var / n) ** 0.5, what
    assert abs(x.var() - var) < 6 * var * ((kurt + 2) / n) ** 0.5, what
    if not discrete:
        assert st.kstest(x, law.cdf).pvalue > 1e-4, what
        return
    vals, counts = onp.unique(x, return_counts=True)
    lo, hi = law.ppf(1e-6), law.ppf(1 - 1e-6)
    support = onp.arange(lo, hi + 1)
    exp = law.pmf(support) * n
    # merge cells into ones of expected count >= 20, tails included
    edges, acc = [], 0.0
    for k, e in zip(support, exp):
        acc += e
        if acc >= 20:
            edges.append(k)
            acc = 0.0
    edges[-1] = onp.inf
    obs = onp.histogram(x, onp.concatenate([[-onp.inf], onp.asarray(
        edges[:-1]) + 0.5, [onp.inf]]))[0]
    cdf = law.cdf(onp.asarray(edges[:-1]))
    expect = onp.diff(onp.concatenate([[0.0], cdf, [1.0]])) * n
    assert st.chisquare(obs, expect).pvalue > 1e-4, (what, vals[:5])


@pytest.mark.parametrize("name", list(LAWS))
def test_sampler_law(name):
    kw, law, discrete = LAWS[name]
    tmx.random.seed(11)
    with tmx.cpu():
        x = getattr(tmx.nd, name)(shape=(N,), **kw).asnumpy()
    _moments_and_fit(x, law, discrete, name)


@pytest.mark.parametrize("name", list(PARAM_LAWS))
def test_param_sampler_law(name):
    params, law, discrete = PARAM_LAWS[name]
    tmx.random.seed(12)
    with tmx.cpu():
        x = getattr(tmx.nd, name)(
            *[tmx.nd.array(p) for p in params], shape=N).asnumpy()
    assert x.shape == (2, N)
    _moments_and_fit(x[0], law, discrete, name)


def test_bernoulli_law():
    tmx.random.seed(13)
    with tmx.cpu():
        x = tmx.nd.random_bernoulli(0.3, shape=(N,)).asnumpy()
    _moments_and_fit(x, st.bernoulli(0.3), True, "bernoulli")


def test_multinomial_law_and_log_probability():
    """Row frequencies against the probabilities (a zero entry is never
    drawn); ``get_prob`` is the reference's ``log_softmax(log(max(p,
    1e-37)))`` at the port's draws."""
    p = onp.array([[0.1, 0.0, 0.6, 0.3], [0.25, 0.25, 0.25, 0.25]],
                  "float32")
    tmx.random.seed(14)
    with tmx.cpu():
        s, logp = tmx.nd.sample_multinomial(tmx.nd.array(p), shape=N,
                                            get_prob=True)
    s, logp = s.asnumpy(), logp.asnumpy()
    assert s.shape == logp.shape == (2, N) and s.dtype == onp.int32
    for row in range(2):
        counts = onp.bincount(s[row], minlength=4)
        nz = p[row] > 0
        assert counts[~nz].sum() == 0
        want = p[row][nz].astype("float64")
        assert st.chisquare(counts[nz], want / want.sum() * N).pvalue > 1e-4
    lg = onp.log(onp.maximum(p, 1e-37))
    ls = lg - onp.log(onp.exp(lg).sum(-1, keepdims=True))
    onp.testing.assert_allclose(logp, onp.take_along_axis(ls, s, -1),
                                rtol=1e-6, atol=1e-6)


def test_shuffle_is_a_permutation_of_rows():
    x = onp.arange(40, dtype="float32").reshape(20, 2)
    tmx.random.seed(15)
    with tmx.cpu():
        y = tmx.nd.shuffle(tmx.nd.array(x)).asnumpy()
    assert not (y == x).all()
    assert sorted(map(tuple, y)) == sorted(map(tuple, x))
    assert (y[:, 1] == y[:, 0] + 1).all()


# the calls of the shape and dtype contract, one a sampler
CALLS = {
    "random_uniform": lambda nd: nd.random_uniform(shape=None),
    "uniform": lambda nd: nd.uniform(shape=3, dtype="float64"),
    "random_normal": lambda nd: nd.random_normal(shape=(2, 3),
                                                 dtype="float16"),
    "normal": lambda nd: nd.normal(shape=(4,)),
    "random_gamma": lambda nd: nd.random_gamma(shape=(2, 2), alpha=0.5),
    "random_exponential": lambda nd: nd.random_exponential(shape=5),
    "random_poisson": lambda nd: nd.random_poisson(shape=(3,),
                                                   dtype="int64"),
    "random_randint": lambda nd: nd.random_randint(shape=(3,), low=0,
                                                   high=9),
    "random_bernoulli": lambda nd: nd.random_bernoulli(0.5, shape=(2, 2),
                                                       dtype="int32"),
    "random_negative_binomial": lambda nd: nd.random_negative_binomial(
        shape=(2,), k=2, p=0.5),
    "random_generalized_negative_binomial":
        lambda nd: nd.random_generalized_negative_binomial(shape=(2,)),
    "sample_multinomial": lambda nd: nd.sample_multinomial(
        nd.array([[0.5, 0.5], [0.1, 0.9]])),
    "sample_multinomial_1d": lambda nd: nd.sample_multinomial(
        nd.array([0.5, 0.5]), shape=(2, 3), get_prob=True),
    "sample_multinomial_tuple1": lambda nd: nd.sample_multinomial(
        nd.array([0.5, 0.5]), shape=(1,)),
    "shuffle": lambda nd: nd.shuffle(nd.array([[1, 2], [3, 4], [5, 6]])),
    "sample_uniform": lambda nd: nd.sample_uniform(
        nd.array([0.0, 1.0]), nd.array([1.0, 2.0]), shape=(2, 3)),
    "sample_normal": lambda nd: nd.sample_normal(
        nd.array([[0.0], [1.0]]), nd.array([[1.0], [2.0]])),
    "sample_gamma": lambda nd: nd.sample_gamma(
        nd.array([1.0, 2.0]), nd.array([1.0, 2.0]), shape=4),
    "sample_exponential": lambda nd: nd.sample_exponential(
        nd.array([1.0, 2.0]), shape=(1,)),
    "sample_poisson": lambda nd: nd.sample_poisson(nd.array([1.0, 2.0]),
                                                   shape=3, dtype="int32"),
}


def _sig(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [(o.shape, onp.dtype(o.dtype).name) for o in outs]


@pytest.mark.parametrize("case", list(CALLS))
def test_shape_and_dtype_as_the_reference(case):
    want = _sig(CALLS[case](mx.nd))
    with tmx.cpu():
        got = _sig(CALLS[case](tmx.nd))
    assert got == want


def _big(name):
    """A 64-element draw of sampler ``name``, too big for two seeds to
    agree on by chance."""
    if name in LAWS:
        return lambda nd: getattr(nd, name)(shape=(64,), **LAWS[name][0])
    if name in PARAM_LAWS:
        return lambda nd: getattr(nd, name)(
            *[nd.array(p) for p in PARAM_LAWS[name][0]], shape=32)
    return {"random_bernoulli": lambda nd: nd.random_bernoulli(
                0.5, shape=(64,)),
            "sample_multinomial": lambda nd: nd.sample_multinomial(
                nd.array([0.5, 0.5]), shape=64),
            "shuffle": lambda nd: nd.shuffle(nd.arange(64))}[name]


@pytest.mark.parametrize("case", list(CALLS))
def test_a_seed_repeats_and_another_differs(case):
    def draw(seed, call):
        tmx.random.seed(seed)
        with tmx.cpu():
            out = call(tmx.nd)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in outs]
    for x, y in zip(draw(21, CALLS[case]), draw(21, CALLS[case])):
        onp.testing.assert_array_equal(x, y)
    big = _big(case.split("_1d")[0].split("_tuple")[0])
    assert not onp.array_equal(draw(21, big)[0], draw(22, big)[0])


def test_draws_leave_torch_global_generator_alone():
    torch.manual_seed(0)
    want = torch.rand(3)
    torch.manual_seed(0)
    with tmx.cpu():
        for name in LAWS:
            getattr(tmx.nd, name)(shape=(4,))
        tmx.nd.random_bernoulli(shape=(4,))
        tmx.nd.shuffle(tmx.nd.arange(8))
        tmx.nd.sample_multinomial(tmx.nd.array([0.5, 0.5]), shape=4)
        tmx.nd.sample_gamma(tmx.nd.array([1.0]), tmx.nd.array([1.0]),
                            shape=4)
    assert torch.equal(torch.rand(3), want)


def test_positional_parameters_are_dropped():
    """``random_uniform(5, 6, shape=(3,))`` draws in [0, 1) in the
    reference: its positional parameters are ignored."""
    with tmx.cpu():
        x = tmx.nd.random_uniform(5, 6, shape=(1000,)).asnumpy()
        y = tmx.nd.random_normal(5, 6, shape=(1000,)).asnumpy()
    assert 0 <= x.min() and x.max() < 1
    assert abs(y.mean()) < 0.2
    ref = mx.nd.random_uniform(5, 6, shape=(1000,)).asnumpy()
    assert 0 <= ref.min() and ref.max() < 1


def test_out_rebinds_and_ctx_defaults_to_the_scope():
    with tmx.cpu():
        out = tmx.nd.zeros((2,))
        r = tmx.nd.random_normal(shape=(3, 2), out=out)
        assert r is out and out.shape == (3, 2)
        assert out.context.device_type == "cpu"
        alias = tmx.nd.zeros((2, 2))[0]           # a view writes through
        tmx.nd.random_uniform(shape=(2,), low=1.0, high=2.0, out=alias)
        assert (alias.asnumpy() >= 1).all()


def test_sample_multinomial_shape_one_drops_the_axis():
    with tmx.cpu():
        p = tmx.nd.array([[0.2, 0.8], [1.0, 0.0]])
        assert tmx.nd.sample_multinomial(p).shape == (2,)
        assert tmx.nd.sample_multinomial(p, shape=(1,)).shape == (2, 1)
        assert tmx.nd.sample_multinomial(p[1]).shape == ()
        assert tmx.nd.sample_multinomial(p[1], shape=6).asnumpy().tolist() \
            == [0] * 6
