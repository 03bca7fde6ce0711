"""The layers GPT-2 uses (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Dense``, ``Embedding``,
``LayerNorm``, ``GELU`` and ``Dropout``, with the reference's parameter
names (``weight``/``bias``, ``gamma``/``beta``) and math.

Shapes are declared up front (``in_units``, ``in_channels``): the
reference's shape inference at the first forward is not ported, nor are
options GPT-2 does not use (``Dense`` applies to the last axis, as the
reference's ``flatten=False`` does, and always has a bias).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import base as _base
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["Dense", "Embedding", "LayerNorm", "GELU", "Dropout"]


class Dense(HybridBlock):
    """Fully connected over the last axis: ``out = x · Wᵀ + b`` with ``W``
    (units, in_units), the ``FullyConnected`` layout
    (``ndarray/ops.py:934-936``)."""

    def __init__(self, units, in_units):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense needs in_units: the port does not "
                             "infer shapes at the first forward")
        self._new_param("weight", (units, in_units))
        self._new_param("bias", (units,))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(HybridBlock):
    """Row lookup; out-of-range ids clamp to the table, as the
    reference's ``take(mode='clip')`` does."""

    def __init__(self, input_dim, output_dim):
        super().__init__()
        self._input_dim = input_dim
        self._new_param("weight", (input_dim, output_dim))

    def forward(self, x):
        return F.embedding(x.clamp(0, self._input_dim - 1), self.weight)


class LayerNorm(HybridBlock):
    """``(x - mean) · rsqrt(var + eps) · gamma + beta`` over the last
    axis, with the biased variance (``ndarray/ops.py:1236-1247``)."""

    def __init__(self, epsilon, in_channels):
        super().__init__()
        self._eps = epsilon
        self._new_param("gamma", (in_channels,))
        self._new_param("beta", (in_channels,))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self._eps) * self.gamma \
            + self.beta


class GELU(HybridBlock):
    """The exact erf form (``ndarray/ops.py:911-912``), not the tanh
    approximation."""

    def forward(self, x):
        return F.gelu(x)


class Dropout(HybridBlock):
    """Inverted dropout, active only in training mode."""

    def __init__(self, rate):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        if _base.is_training():
            return F.dropout(x, self._rate, training=True)
        return x
