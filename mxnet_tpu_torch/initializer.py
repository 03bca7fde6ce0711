"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

An initializer fills one tensor in place from an explicit
``torch.Generator``.  As in the reference, parameters are filled by
name: ``gamma`` and ``running_var`` with ones, ``beta``, ``bias`` and
``running_mean`` with zeros, anything else by :meth:`_init_weight` —
unless the initializer was attached to the parameter itself
(``Dense(bias_initializer='ones')``, ``Parameter(init=...)``), which
wins over the name rule (``explicit``).  Random draws are made in
float32 and cast to the parameter's dtype, as the reference's are.

The same seed gives different numbers here than in the JAX package:
torch's generators are not jax's threefry, so parity runs copy
parameters across instead of re-drawing them.  The deterministic
initializers (``Zero``, ``One``, ``Constant``, ``Bilinear``,
``LSTMBias``) give the reference's values bit for bit; the random ones
keep its distributions, bounds and fan arithmetic.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from . import base as _base

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "create", "register"]

_registry = _base.registry("initializer")
register = _registry.register


class Initializer:
    """Base initializer; subclasses implement :meth:`_init_weight`."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, explicit=False):
        """Fill ``arr`` (an NDArray or a tensor) in place from
        ``mx.random``'s generator of its device."""
        self.init_array(name if isinstance(name, str) else str(name), arr,
                        explicit=explicit)

    def init_array(self, name: str, arr, explicit=False):
        """Fill ``arr`` (an NDArray or a tensor) in place by the name
        rules of :meth:`init_tensor`; ``explicit=True`` (the user attached
        this initializer to this parameter) skips them."""
        from . import random as _random
        t = arr.tensor if hasattr(arr, "tensor") else arr
        with torch.no_grad():
            self.init_tensor(name, t, _random.generator(t.device),
                             explicit=explicit)

    def init_tensor(self, name: str, t: torch.Tensor,
                    generator: torch.Generator, explicit: bool = False):
        """Fill ``t`` in place by the reference's name rules; an
        ``explicit`` initializer skips them."""
        if explicit:
            self._init_weight(name, t, generator)
            return
        name_l = name.lower()
        if name_l.endswith("gamma"):
            t.fill_(1.0)
        elif name_l.endswith("beta") or name_l.endswith("bias"):
            t.zero_()
        elif "running_mean" in name_l or "moving_mean" in name_l:
            t.zero_()
        elif "running_var" in name_l or "moving_var" in name_l:
            t.fill_(1.0)
        else:
            self._init_weight(name, t, generator)

    def _init_weight(self, name: str, t: torch.Tensor,
                     generator: torch.Generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])


def _uniform(t, scale, generator):
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    draw.uniform_(-scale, scale, generator=generator)
    t.copy_(draw)


def _normal(t, sigma, generator):
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    draw.normal_(0.0, 1.0, generator=generator)
    t.copy_(sigma * draw)


@register("zeros")
class Zero(Initializer):
    def _init_weight(self, name, t, generator):
        t.zero_()


@register("ones")
class One(Initializer):
    def _init_weight(self, name, t, generator):
        t.fill_(1.0)


@register()
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, t, generator):
        t.copy_(torch.from_numpy(np.array(self.value, dtype=np.float32)))


@register()
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = float(scale)

    def _init_weight(self, name, t, generator):
        _uniform(t, self.scale, generator)

    def __repr__(self):
        return f"Uniform(scale={self.scale})"


@register()
class Normal(Initializer):
    """N(0, sigma²)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, t, generator):
        _normal(t, self.sigma, generator)


@register()
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of a QR of a normal draw,
    signs fixed by R's diagonal; (nout, prod(rest)) rows or columns are
    orthonormal, whichever are fewer."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_weight(self, name, t, generator):
        nout = t.shape[0]
        nin = int(np.prod(t.shape[1:]))
        a = torch.empty((nout, nin), dtype=torch.float32, device=t.device)
        a.normal_(0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(a if nout >= nin else a.T)
        q = q * torch.sign(torch.diagonal(r))
        if nout < nin:
            q = q.T
        t.copy_(self.scale * q.reshape(t.shape))


@register()
class Xavier(Initializer):
    """Glorot: U(-s, s) or N(0, s²) with s = sqrt(magnitude / factor),
    the factor the fan-in, fan-out or their mean (receptive field
    included for ndim > 2)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape) -> float:
        """The reference's fan arithmetic (``initializer.py:144-162``)."""
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {tuple(shape)}")
        if len(shape) > 2:
            hw_scale = float(np.prod(shape[2:]))
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, t, generator):
        try:
            s = self.scale(t.shape)
        except ValueError:
            raise ValueError(f"Xavier requires ndim>=2, got "
                             f"{tuple(t.shape)} for {name}") from None
        if self.rnd_type == "uniform":
            _uniform(t, s, generator)
        else:
            _normal(t, s, generator)


@register()
class MSRAPrelu(Xavier):
    """He initialization for PReLU nets: Gaussian Xavier at magnitude
    2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register()
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, name, t, generator):
        shape = tuple(t.shape)
        f = int(np.ceil(shape[3] / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))) \
            .astype(np.float32)
        t.copy_(torch.from_numpy(weight.reshape(shape)))


@register()
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter set to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, t, generator):
        b = np.zeros(tuple(t.shape), dtype=np.float32)
        num_hidden = t.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        t.copy_(torch.from_numpy(b))


def create(init, **kwargs) -> Initializer:
    """An initializer from itself, None (``Uniform()``) or a registered
    name (``'zeros'``, ``'ones'``, ``'xavier'``, ...)."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform()
    if isinstance(init, str):
        return _registry.get(init)(**kwargs)
    raise ValueError(f"cannot create initializer from {init!r}")
