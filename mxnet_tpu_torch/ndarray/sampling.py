"""The ``nd`` random samplers (counterpart of the sampling ops of
``mxnet_tpu/ndarray/ops.py``), re-exported by :mod:`.ops`.

Every draw comes from the port's per-device generator
(:func:`mxnet_tpu_torch.random.generator`), never from torch's global
one, so ``mx.random.seed(n)`` repeats a stream.  Philox gives other bits
than the reference's threefry: the contracts kept are the reference's
shapes, dtypes and distributions, and that one seed repeats one stream.

The surface is the reference's, quirks included:

- ``random_*`` take their parameters by keyword; positional arguments
  are dropped (``random_uniform(5, 6, shape=(3,))`` draws in [0, 1)).
  ``shape=None`` is ``()``, an int ``n`` is ``(n,)``; ``ctx`` defaults
  to the current context; ``out=`` rebinds the array given.
- float64 and int64 read as float32 and int32 (jax's defaults).
- ``random_randint``'s ``high`` is exclusive.
- The negative binomials draw a gamma rate, then a Poisson count at it.
- ``sample_*`` take one parameter array per parameter and draw
  ``shape`` samples for each element, on the parameters' device.
"""
from __future__ import annotations

import builtins
import math

import torch

from .. import random as _random
from ..base import torch_dtype
from ..context import resolve_device
from .ndarray import NDArray
from .ops import _as_nd, invoke   # ops imports this module at its end

__all__: list = []

# jax's dtypes with 64-bit types off
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _dtype(dtype) -> torch.dtype:
    dt = torch_dtype(dtype)
    return _NARROW.get(dt, dt)


def _shape(shape) -> tuple:
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rebind(out, t):
    """``out=``: the array given takes the draws, as an in-place
    operator rebinds (an alias writes through)."""
    if out._alias:
        with torch.no_grad():
            out._t.copy_(t)
    else:
        out._t = t
    return out


def _gamma(alpha, shape, gen, dev, dt=torch.float32):
    """Gamma(alpha, 1) draws of ``shape``; ``alpha`` a number or a tensor
    broadcast to it."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=gen).to(dt)


def _poisson(rate, gen):
    return torch.poisson(rate.float().contiguous(), generator=gen)


def _sample_op(name, sampler):
    def op(*_dropped, shape=None, dtype="float32", ctx=None, out=None,
           **params):
        dev = resolve_device(ctx)
        val = sampler(_random.generator(dev), _shape(shape), _dtype(dtype),
                      dev, **params)
        return NDArray(val) if out is None else _rebind(out, val)
    op.__name__ = name
    globals()[name] = op
    __all__.append(name)
    return op


_sample_op("random_uniform",
           lambda g, shape, dt, dev, low=0.0, high=1.0, **kw:
           low + (high - low) * torch.rand(shape, generator=g, dtype=dt,
                                           device=dev))
_sample_op("random_normal",
           lambda g, shape, dt, dev, loc=0.0, scale=1.0, **kw:
           loc + scale * torch.randn(shape, generator=g, dtype=dt,
                                     device=dev))
_sample_op("random_gamma",
           lambda g, shape, dt, dev, alpha=1.0, beta=1.0, **kw:
           beta * _gamma(alpha, shape, g, dev, dt))
_sample_op("random_exponential",
           lambda g, shape, dt, dev, lam=1.0, **kw:
           torch.empty(shape, dtype=dt, device=dev).exponential_(
               generator=g) / lam)
_sample_op("random_poisson",
           lambda g, shape, dt, dev, lam=1.0, **kw:
           _poisson(torch.full(shape, float(lam), device=dev), g).to(dt))
_sample_op("random_randint",
           lambda g, shape, dt, dev, low=0, high=2, **kw:
           torch.randint(int(low), int(high), shape, generator=g,
                         device=dev).to(dt))
_sample_op("random_negative_binomial",
           lambda g, shape, dt, dev, k=1, p=1.0, **kw:
           _poisson(_gamma(k, shape, g, dev) * (1 - p) /
                    builtins.max(p, 1e-12), g).to(dt))
_sample_op("random_generalized_negative_binomial",
           lambda g, shape, dt, dev, mu=1.0, alpha=1.0, **kw:
           _poisson(_gamma(1.0 / builtins.max(alpha, 1e-12), shape, g, dev)
                    * (alpha * mu), g).to(dt))

normal = random_normal      # noqa: F821 (made by _sample_op)
uniform = random_uniform    # noqa: F821
__all__ += ["normal", "uniform"]


def random_bernoulli(p=0.5, shape=(), dtype="float32", ctx=None):
    dev = resolve_device(ctx)
    probs = torch.full(_shape(shape), float(p), device=dev)
    return NDArray(torch.bernoulli(probs, generator=_random.generator(dev))
                   .to(_dtype(dtype)))


def sample_multinomial(data, shape=1, get_prob=False, dtype="int32"):
    """Draws from the categorical rows of ``data`` (K,) or (B, K),
    ``shape`` of them a row; an int 1 drops the sample axis.  With
    ``get_prob`` also the log-probability of each draw,
    ``log_softmax(log(max(p, 1e-37)))`` at it (not differentiable, as
    the reference's)."""
    data = _as_nd(data)
    gen = _random.generator(data._t.device)
    sample_shape = _shape(shape)
    n = math.prod(sample_shape)
    scalar = shape == 1
    dt = _dtype(dtype)

    def f(p):
        rows = p.reshape(-1, p.shape[-1]).float().clamp_min(1e-37)
        s = torch.multinomial(rows, n, replacement=True, generator=gen)
        logp = torch.gather(torch.log_softmax(torch.log(rows), dim=-1), 1, s)
        lead = p.shape[:-1]
        if scalar:
            s, logp = s[:, 0], logp[:, 0]
        else:
            s = s.reshape(-1, *sample_shape)
            logp = logp.reshape(-1, *sample_shape)
        s, logp = s.reshape(lead + s.shape[1:]), logp.reshape(
            lead + logp.shape[1:])
        return (s.to(dt), logp) if get_prob else s.to(dt)
    return invoke("sample_multinomial", f, [data], differentiable=False)


def shuffle(data):
    """``data`` with its first axis in a random order."""
    data = _as_nd(data)
    gen = _random.generator(data._t.device)
    return invoke("shuffle", lambda x: x[torch.randperm(
        x.shape[0], generator=gen, device=x.device)], [data],
        differentiable=False)


def _param_sample_op(name, sampler):
    def op(*params, shape=(), dtype="float32", ctx=None, **kw):
        nds = [_as_nd(p) for p in params]
        dt = _dtype(dtype)
        sample_shape = _shape(shape)
        gen = _random.generator(nds[0]._t.device)

        def f(*ps):
            full = ps[0].shape + sample_shape
            broad = [p.reshape(p.shape + (1,) * len(sample_shape))
                     for p in ps]
            return sampler(gen, full, dt, ps[0].device, *broad)
        return invoke(name, f, nds, differentiable=False)
    op.__name__ = name
    globals()[name] = op
    __all__.append(name)
    return op


_param_sample_op("sample_uniform",
                 lambda g, full, dt, dev, low, high:
                 low + (high - low) * torch.rand(full, generator=g, dtype=dt,
                                                 device=dev))
_param_sample_op("sample_normal",
                 lambda g, full, dt, dev, mu, sigma:
                 mu + sigma * torch.randn(full, generator=g, dtype=dt,
                                          device=dev))
_param_sample_op("sample_gamma",
                 lambda g, full, dt, dev, alpha, beta:
                 beta * _gamma(alpha, full, g, dev, dt))
_param_sample_op("sample_exponential",
                 lambda g, full, dt, dev, lam:
                 torch.empty(full, dtype=dt, device=dev).exponential_(
                     generator=g) / lam)
_param_sample_op("sample_poisson",
                 lambda g, full, dt, dev, lam:
                 _poisson(lam.expand(full), g).to(dt))

__all__ += ["random_bernoulli", "sample_multinomial", "shuffle"]
