"""``mx.np.random`` (counterpart of ``mxnet_tpu/numpy/random.py``).

Every draw comes from the port's per-device generator
(:func:`mxnet_tpu_torch.random.generator`, Philox on the card), so
``mx.np.random.seed(n)`` repeats a stream, as the reference's does.  The
reference draws threefry keys: the bits differ, the laws are the
reference's (``pareto`` is jax's, with support from 1, and the negative
binomial a Poisson count at a gamma rate), and so are the shapes and the
32-bit dtypes.  ``size=None`` draws one value (shape ``()``).
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..ndarray.sampling import _gamma, _poisson
from . import _T, _fl, _tdtype

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint",
           "choice", "shuffle", "permutation", "multinomial", "gamma",
           "beta", "exponential", "poisson", "lognormal", "laplace",
           "gumbel", "logistic", "chisquare", "multivariate_normal",
           "binomial", "bernoulli", "weibull", "pareto", "power", "rayleigh",
           "f", "standard_normal", "standard_exponential", "standard_cauchy",
           "negative_binomial"]


def seed(s):
    _random.seed(int(s))


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _dev(ctx=None, device=None, *params):
    """The device of the draw: ``ctx``/``device`` when given, else the
    first array parameter's, else the current context."""
    if ctx is not None or device is not None:
        return resolve_device(ctx if ctx is not None else device)
    for p in params:
        if isinstance(p, NDArray):
            return p._t.device
    return resolve_device(None)


def _gen(dev):
    return _random.generator(dev)


def _p(x, dev):
    """A parameter as a float32 tensor on ``dev``."""
    return _fl(_T(x)).to(dev) if isinstance(x, NDArray) else \
        torch.as_tensor(x, dtype=torch.float32, device=dev)


def _size(size, *params):
    """The draw's shape: ``size``, else the parameters' broadcast."""
    if size is not None:
        return _shape(size)
    return tuple(torch.broadcast_shapes(*[tuple(p.shape) for p in params]))


def _uniform(shape, dev):
    return torch.rand(shape, generator=_gen(dev), device=dev)


def _rebind(out, val):
    with torch.no_grad():
        out._t.copy_(val)
    return out


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None):
    dev = _dev(ctx, device, low, high)
    lo, hi = _p(low, dev), _p(high, dev)
    val = lo + (hi - lo) * _uniform(_size(size, lo, hi), dev)
    val = val.to(_tdtype(dtype or "float32"))
    return NDArray(val) if out is None else _rebind(out, val)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None,
           out=None):
    dev = _dev(ctx, device, loc, scale)
    mu, sd = _p(loc, dev), _p(scale, dev)
    z = torch.randn(_size(size, mu, sd), generator=_gen(dev), device=dev)
    val = (z * sd + mu).to(_tdtype(dtype or "float32"))
    return NDArray(val) if out is None else _rebind(out, val)


def randn(*shape, dtype=None):
    return normal(0.0, 1.0, size=shape, dtype=dtype)


def rand(*shape, dtype=None):
    return uniform(0.0, 1.0, size=shape, dtype=dtype)


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None):
    if high is None:
        low, high = 0, low
    dev = _dev(ctx, device)
    val = torch.randint(int(low), int(high), _shape(size),
                        generator=_gen(dev), device=dev)
    return NDArray(val.to(_tdtype(dtype or "int32")))


def choice(a, size=None, replace=True, p=None, ctx=None, device=None):
    dev = _dev(ctx, device, a, p)
    pool = torch.arange(a, device=dev, dtype=torch.int32) \
        if isinstance(a, int) else _T(a).to(dev)
    n = pool.shape[0]
    shape = _shape(size)
    k = int(torch.tensor(shape).prod()) if shape else 1
    w = torch.ones(n, device=dev) if p is None else _p(p, dev)
    if replace:
        idx = torch.multinomial(w, k, replacement=True, generator=_gen(dev))
    elif p is None:
        idx = torch.randperm(n, generator=_gen(dev), device=dev)[:k]
    else:
        idx = torch.multinomial(w, k, replacement=False,
                                generator=_gen(dev))
    return NDArray(pool.index_select(0, idx).reshape(
        shape + tuple(pool.shape[1:])))


def shuffle(x):
    """Shuffle ``x`` along its first axis, in place (MXNet's)."""
    dev = x._t.device
    perm = torch.randperm(x.shape[0], generator=_gen(dev), device=dev)
    with torch.no_grad():
        x._t.copy_(x._t.index_select(0, perm))


def permutation(x):
    if isinstance(x, int):
        dev = _dev()
        return NDArray(torch.randperm(x, generator=_gen(dev),
                                      device=dev).to(torch.int32))
    t = _T(x)
    perm = torch.randperm(t.shape[0], generator=_gen(t.device),
                          device=t.device)
    return NDArray(t.index_select(0, perm))


def multinomial(n, pvals, size=None):
    dev = _dev(None, None, pvals)
    pv = _p(pvals, dev)
    shape = _shape(size)
    k = int(torch.tensor(shape).prod()) if shape else 1
    draws = torch.multinomial(pv.expand(k, -1), int(n), replacement=True,
                              generator=_gen(dev))
    counts = torch.zeros((k, pv.shape[-1]), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, draws, torch.ones_like(draws))
    return NDArray(counts.reshape(shape + (pv.shape[-1],)).to(torch.int32))


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, device=None):
    dev = _dev(ctx, device, shape)
    a = _p(shape, dev)
    draws = _gamma(a, _size(size, a), _gen(dev), dev)
    return NDArray((draws * scale).to(_tdtype(dtype or "float32")))


def beta(a, b, size=None, dtype=None, ctx=None, device=None):
    dev = _dev(ctx, device, a, b)
    at, bt = _p(a, dev), _p(b, dev)
    shape = _size(size, at, bt)
    x = _gamma(at, shape, _gen(dev), dev)
    y = _gamma(bt, shape, _gen(dev), dev)
    return NDArray((x / (x + y)).to(_tdtype(dtype or "float32")))


def exponential(scale=1.0, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, scale)
    sc = _p(scale, dev)
    e = torch.empty(_size(size, sc), device=dev).exponential_(
        generator=_gen(dev))
    return NDArray(e * sc)


def poisson(lam=1.0, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, lam)
    rate = _p(lam, dev)
    rate = rate.expand(_size(size, rate)).contiguous()
    return NDArray(_poisson(rate, _gen(dev)).to(torch.int32))


def lognormal(mean=0.0, sigma=1.0, size=None, ctx=None, device=None):
    return NDArray(torch.exp(normal(mean, sigma, size, ctx=ctx,
                                    device=device)._t))


def _loc_scale(loc, scale, size, ctx, device, draw):
    dev = _dev(ctx, device, loc, scale)
    mu, sd = _p(loc, dev), _p(scale, dev)
    u = draw(_size(size, mu, sd), dev)
    return NDArray(u * sd + mu)


def laplace(loc=0.0, scale=1.0, size=None, ctx=None, device=None):
    def draw(shape, dev):
        u = _uniform(shape, dev) - 0.5
        return -torch.sign(u) * torch.log1p(-2.0 * u.abs())
    return _loc_scale(loc, scale, size, ctx, device, draw)


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None, device=None):
    def draw(shape, dev):
        u = _uniform(shape, dev).clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))
    return _loc_scale(loc, scale, size, ctx, device, draw)


def logistic(loc=0.0, scale=1.0, size=None, ctx=None, device=None):
    def draw(shape, dev):
        u = _uniform(shape, dev).clamp(1e-7, 1 - 1e-7)
        return torch.log(u) - torch.log1p(-u)
    return _loc_scale(loc, scale, size, ctx, device, draw)


def chisquare(df, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, df)
    d = _p(df, dev)
    return NDArray(2.0 * _gamma(d / 2.0, _size(size, d), _gen(dev), dev))


def multivariate_normal(mean, cov, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, mean, cov)
    mu, c = _p(mean, dev), _p(cov, dev)
    chol = torch.linalg.cholesky(c)
    shape = _shape(size) + tuple(mu.shape)
    z = torch.randn(shape, generator=_gen(dev), device=dev)
    return NDArray(mu + z @ chol.T)


def binomial(n, p, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, n, p)
    nt, pt = _p(n, dev), _p(p, dev)
    shape = _size(size, nt, pt)
    val = torch.binomial(nt.expand(shape).contiguous(),
                         pt.expand(shape).contiguous(), generator=_gen(dev))
    return NDArray(val)             # float32 counts, as jax's binomial


def bernoulli(p, size=None, dtype=None, ctx=None, device=None):
    dev = _dev(ctx, device, p)
    pt = _p(p, dev)
    val = torch.bernoulli(pt.expand(_size(size, pt)).contiguous(),
                          generator=_gen(dev))
    return NDArray(val.to(_tdtype(dtype)) if dtype is not None
                   else val.bool())


def weibull(a, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, a)
    at = _p(a, dev)
    u = _uniform(_size(size, at), dev)
    return NDArray((-torch.log1p(-u)) ** (1.0 / at))


def pareto(a, size=None, ctx=None, device=None):
    """Pareto with scale 1 (support from 1), jax's law, as the
    reference draws it."""
    dev = _dev(ctx, device, a)
    at = _p(a, dev)
    e = torch.empty(_size(size, at), device=dev).exponential_(
        generator=_gen(dev))
    return NDArray(torch.exp(e / at))


def power(a, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, a)
    at = _p(a, dev)
    u = _uniform(_size(size, at), dev)
    return NDArray(u ** (1.0 / at))


def rayleigh(scale=1.0, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, scale)
    sc = _p(scale, dev)
    u = _uniform(_size(size, sc), dev)
    return NDArray(sc * torch.sqrt(-2.0 * torch.log1p(-u)))


def f(dfnum, dfden, size=None, ctx=None, device=None):
    num = chisquare(dfnum, size=size, ctx=ctx, device=device)._t / dfnum
    den = chisquare(dfden, size=size, ctx=ctx, device=device)._t / dfden
    return NDArray(num / den)


def standard_normal(size=None, ctx=None, device=None):
    return normal(0.0, 1.0, size, ctx=ctx, device=device)


def standard_exponential(size=None, ctx=None, device=None):
    return exponential(1.0, size, ctx=ctx, device=device)


def standard_cauchy(size=None, ctx=None, device=None):
    dev = _dev(ctx, device)
    u = _uniform(_shape(size), dev)
    return NDArray(torch.tan(math.pi * (u - 0.5)))


def negative_binomial(n, p, size=None, ctx=None, device=None):
    """NB(n, p) as the Gamma-Poisson mixture (numpy's law: failures
    before the n-th success)."""
    dev = _dev(ctx, device, n, p)
    nt, pt = _p(n, dev), _p(p, dev)
    shape = _size(size, nt, pt)
    lam = _gamma(nt, shape, _gen(dev), dev) * (1 - pt) / pt
    return NDArray(_poisson(lam.expand(shape).contiguous(),
                            _gen(dev)).to(torch.int32))
