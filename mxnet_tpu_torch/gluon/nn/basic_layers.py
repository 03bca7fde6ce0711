"""Core Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): the containers ``Sequential``
and ``HybridSequential``, ``Dense``, ``Dropout``, ``Embedding``,
``LayerNorm``, the norm layers over batch or group statistics
(``BatchNorm``, ``SyncBatchNorm``, ``GroupNorm``, ``InstanceNorm``),
``Flatten``, the activations and the lambda blocks, with the reference's
signatures, parameter names (``weight``/``bias``, ``gamma``/``beta``,
``running_mean``/``running_var``, ``alpha``) and math.

A 0 in a declared size (``Dense(128)``'s ``in_units``, ``LayerNorm``'s
``in_channels``) defers the parameter: the layer's first call infers it
from its input.  The layers that carry a product or a norm consult the
amp cast policy under the reference's op names (``FullyConnected``,
``LayerNorm``, ``BatchNorm``, ...), so ``mx.amp.init()`` gives them the
dtypes the reference's dispatcher gives (``amp/lists.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ... import amp as _amp
from ... import base as _base
from ... import initializer as init_mod
from ... import random as _random
from ...ndarray import ops
from ...ndarray.ops import ACTIVATION_FNS
from ...ops import dots as _dots
from ..block import Block, HybridBlock, _run_nd

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "SyncBatchNorm", "LayerNorm", "GroupNorm",
           "InstanceNorm", "Flatten", "Activation", "LeakyReLU", "PReLU", "ELU",
           "SELU", "GELU", "Swish", "SiLU", "Lambda", "HybridLambda",
           "Identity"]


class _Container:
    """``add``, ``len``, indexing, slicing and iteration over the
    children, which are named ``"0"``, ``"1"``, ... as the reference's
    ``register_child`` names them."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for b in self._modules.values():
            x = b(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        children = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*children[key])
            return net
        return children[key]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Container, Block):
    """Stack of Blocks run in order."""


class HybridSequential(_Container, HybridBlock):
    """Stack of HybridBlocks run in order."""


class Dense(HybridBlock):
    """Fully connected: ``out = act(x · Wᵀ + b)`` with ``W`` (units,
    in_units), the ``FullyConnected`` layout.  ``flatten`` folds every
    axis but the first into the input features; ``flatten=False``
    applies to the last axis."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self._act = ACTIVATION_FNS[activation] if activation else None
        self._new_param("weight", (units, in_units), dtype,
                        init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self._new_param("bias", (units,), dtype, init=bias_initializer,
                            allow_deferred_init=True)
        else:
            self.bias = None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._set_shape("weight", (self._units, in_units))

    def forward(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        x, w, b = _amp.cast("FullyConnected", x, self.weight, self.bias)
        out = _dots.linear(x, w, b)
        return out if self._act is None else self._act(out)

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape[1] else None} -> {self._units}, "
                f"{self._activation if self._activation else 'linear'})")


class Dropout(HybridBlock):
    """Inverted dropout, active only in training mode: keep each element
    with probability ``1 - rate`` and scale it by ``1 / (1 - rate)``;
    ``axes`` share one draw along them.  The mask is drawn from the
    device's generator in :mod:`mxnet_tpu_torch.random`, so
    ``mx.random.seed`` repeats it."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = float(rate)
        self._axes = axes

    def forward(self, x):
        if not _base.is_training() or self._rate <= 0:
            return x
        shape = list(x.shape)
        for a in self._axes:
            shape[a] = 1
        draw = torch.rand(shape, generator=_random.generator(x.device),
                          device=x.device)
        return torch.where(draw < 1.0 - self._rate, x / (1.0 - self._rate),
                           torch.zeros_like(x))

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class Embedding(HybridBlock):
    """Row lookup; out-of-range ids clamp to the table, as the
    reference's ``take(mode='clip')`` does."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if sparse_grad:
            raise _base.MXNetError("sparse_grad is not ported (ROADMAP A9)")
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._new_param("weight", (input_dim, output_dim), dtype,
                        init=weight_initializer, allow_deferred_init=True)

    def forward(self, x):
        return F.embedding(x.clamp(0, self._input_dim - 1), self.weight)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


def _data_group():
    """The process group over the ambient mesh's data axes (dp and sp),
    or None: no mesh, or those axes are this rank alone."""
    from ...parallel.mesh import current_mesh
    mesh = current_mesh()
    group = None if mesh is None else mesh.group(("dp", "sp"))
    if group is None:
        return None
    import torch.distributed as dist
    return group if dist.get_world_size(group) > 1 else None


def _global_batch_norm(x, gamma, beta, eps, fix_gamma, axis, group):
    """``ops.batch_norm`` in training mode over the global batch: each
    rank holds its rows, and the count, sum and centred sum of squares
    are summed over ``group`` by ``psum``, whose backward sums the
    cotangents too, so the gradients are those of the global batch's
    statistics (the reference's BatchNorm under a sharded batch)."""
    from ...parallel.collectives import psum
    xc = x.movedim(axis % x.dim(), 1)
    dims = [i for i in range(xc.dim()) if i != 1]
    count = torch.full((1,), float(xc.numel() // xc.shape[1]),
                       dtype=xc.dtype, device=xc.device)
    sums = psum(torch.cat([xc.sum(dims), count]), group)
    mean = sums[:-1] / sums[-1]
    xm = xc - mean.reshape((-1,) + (1,) * (xc.dim() - 2))
    var = psum((xm * xm).sum(dims), group) / sums[-1]
    # normalized by the given (global) statistics, through them too
    return ops.batch_norm(x, gamma, beta, mean, var, eps, fix_gamma,
                          False, axis)


class BatchNorm(HybridBlock):
    """Normalize along channel axis ``axis`` (-1 for channels-last) by
    the batch's mean and biased variance in training mode, by the moving
    statistics otherwise or with ``use_global_stats``.  Each training
    call moves ``running_mean``/``running_var`` in place, without a
    graph: ``m * old + (1 - m) * batch`` with the biased batch variance,
    as the reference's layer does (torch's own ``F.batch_norm`` update
    would take the unbiased one).  ``scale``/``center`` False freeze
    ``gamma``/``beta`` (``scale=False`` also fixes gamma at 1).  Under a
    mesh whose data axes span several ranks (``ShardedTrainer``'s
    forward runs under ``use_mesh``) the batch is the global one: its
    statistics are summed over those ranks."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        c = (in_channels,)
        self._new_param("gamma", c, init=gamma_initializer,
                        allow_deferred_init=True, differentiable=scale)
        self._new_param("beta", c, init=beta_initializer,
                        allow_deferred_init=True, differentiable=center)
        self._new_param("running_mean", c, init=running_mean_initializer,
                        allow_deferred_init=True, differentiable=False)
        self._new_param("running_var", c,
                        init=running_variance_initializer,
                        allow_deferred_init=True, differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for attr in ("gamma", "beta", "running_mean", "running_var"):
            self._set_shape(attr, (c,))

    def forward(self, x):
        training = _base.is_training() and not self._use_global_stats
        x, g, b = _amp.cast("BatchNorm", x, self.gamma, self.beta)
        group = _data_group() if training else None
        if group is not None:
            out, mean, var = _global_batch_norm(
                x, g, b, self._eps, not self._scale, self._axis, group)
        else:
            out, mean, var = ops.batch_norm(
                x, g, b, self.running_mean, self.running_var, self._eps,
                not self._scale, training, self._axis)
        if training:
            m = self._momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
        return out

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, eps={self._eps}, "
                f"momentum={self._momentum})")


class SyncBatchNorm(BatchNorm):
    """BatchNorm over the batch of every device: under a mesh the
    statistics are the data axes' (as BatchNorm's are); on one device it
    is BatchNorm (as the reference's is eagerly)."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


class LayerNorm(HybridBlock):
    """``(x - mean) · rsqrt(var + eps) · gamma + beta`` along ``axis``,
    with the biased variance; ``center``/``scale`` False freeze
    ``beta``/``gamma``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = epsilon
        self._new_param("gamma", (in_channels,), init=gamma_initializer,
                        allow_deferred_init=True, differentiable=scale)
        self._new_param("beta", (in_channels,), init=beta_initializer,
                        allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self._set_shape("gamma", (c,))
        self._set_shape("beta", (c,))

    def forward(self, x):
        x, g, b = _amp.cast("LayerNorm", x, self.gamma, self.beta)
        axis = self._axis % x.dim()
        mean = x.mean(dim=axis, keepdim=True)
        var = x.var(dim=axis, unbiased=False, keepdim=True)
        if axis != x.dim() - 1:
            shape = [1] * x.dim()
            shape[axis] = x.shape[axis]
            g, b = g.reshape(shape), b.reshape(shape)
        return (x - mean) * torch.rsqrt(var + self._eps) * g + b

    def __repr__(self):
        return f"LayerNorm(axis={self._axis}, eps={self._eps})"


class _GroupStatsNorm(HybridBlock):
    """``gamma``/``beta`` per channel (axis 1), statistics per sample over
    groups of channels and the spatial axes."""

    _op = None

    def __init__(self, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = epsilon
        self._new_param("gamma", (in_channels,), init=gamma_initializer,
                        allow_deferred_init=True, differentiable=scale)
        self._new_param("beta", (in_channels,), init=beta_initializer,
                        allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        self._set_shape("gamma", (x.shape[1],))
        self._set_shape("beta", (x.shape[1],))

    def forward(self, x):
        x, g, b = _amp.cast(self._op, x, self.gamma, self.beta)
        return F.group_norm(x, self._groups(x), g, b, self._eps)


class GroupNorm(_GroupStatsNorm):
    _op = "GroupNorm"

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)
        self._num_groups = num_groups

    def _groups(self, x):
        return self._num_groups


class InstanceNorm(_GroupStatsNorm):
    """A group per channel.  ``axis`` is accepted and, as in the
    reference, the channel axis is 1."""

    _op = "InstanceNorm"

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)

    def _groups(self, x):
        return x.shape[1]


class Flatten(HybridBlock):
    """(N, ...) → (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0] if x.dim() else 1, -1)

    def __repr__(self):
        return "Flatten"


class Activation(HybridBlock):
    """One of ``nd.Activation``'s functions (``relu``, ``sigmoid``,
    ``tanh``, ``softrelu``, ``softsign``, ...)."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act_type = activation
        self._fn = ACTIVATION_FNS[activation]

    def forward(self, x):
        return self._fn(x)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` (in_channels,)."""

    def __init__(self, alpha_initializer=init_mod.Constant(0.25),
                 in_channels=1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._new_param("alpha", (in_channels,), init=alpha_initializer)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, alpha=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return F.selu(x)


class GELU(HybridBlock):
    """The exact (erf) GELU.  ``approximation`` is accepted and, as in
    the reference, does not change the formula."""

    def __init__(self, approximation="erf", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if approximation not in ("erf", "tanh"):
            raise ValueError(f"approximation={approximation!r}: 'erf' or "
                             "'tanh'")

    def forward(self, x):
        return F.gelu(x)


class Swish(HybridBlock):
    """``x · sigmoid(beta · x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


SiLU = Swish


def _nd_function(function):
    """An ``nd`` function given by name, or ``function`` itself."""
    if isinstance(function, str):
        from ... import ndarray as nd
        return getattr(nd, function)
    return function


class Lambda(Block):
    """Wraps ``function(*NDArrays)`` (or the name of an ``nd``
    function) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = _nd_function(function)

    def forward(self, *args):
        return _run_nd(self._func, args, {})


class HybridLambda(HybridBlock):
    """Wraps ``function(F, x, *args)`` (or the name of an ``nd``
    function) as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            name = function
            function = lambda F, *args: getattr(F, name)(*args)  # noqa: E731
        self._func = function

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)


class Identity(HybridBlock):
    def forward(self, x):
        return x
