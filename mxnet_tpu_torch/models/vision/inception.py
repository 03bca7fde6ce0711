"""Inception v3 (counterpart of ``mxnet_tpu/models/vision/inception.py``):
blocks A (35x35), B (17x17, factorized 7x1/1x7), C (8x8, split 1x3/3x1
branches) and the two grid reductions; branch outputs concatenate on
the channel axis."""
from __future__ import annotations

import torch

from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel, stride=1, pad=0):
    seq = nn.HybridSequential()
    seq.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                      padding=pad, use_bias=False))
    seq.add(nn.BatchNorm(epsilon=0.001))
    seq.add(nn.Activation("relu"))
    return seq


class _Branches(HybridBlock):
    """N branches (children ``b0``, ``b1``, ...) on the same input,
    concatenated along the channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        self.branches = []
        for i, b in enumerate(branches):
            self.register_child(b, f"b{i}")
            self.branches.append(b)

    def forward(self, x):
        return torch.cat([b(x) for b in self.branches], dim=1)


def _pool_branch(channels, avg=True):
    seq = nn.HybridSequential()
    if avg:
        seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    else:
        seq.add(nn.MaxPool2D(pool_size=3, strides=1, padding=1))
    if channels:
        seq.add(_conv(channels, 1))
    return seq


def _seq(*blocks):
    s = nn.HybridSequential()
    s.add(*blocks)
    return s


def _make_A(pool_features):
    return _Branches([
        _conv(64, 1),
        _seq(_conv(48, 1), _conv(64, 5, pad=2)),
        _seq(_conv(64, 1), _conv(96, 3, pad=1), _conv(96, 3, pad=1)),
        _pool_branch(pool_features),
    ])


class _ReductionA(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.c3 = _conv(384, 3, stride=2)
        self.c3d = _seq(_conv(64, 1), _conv(96, 3, pad=1),
                        _conv(96, 3, stride=2))
        self.pool = nn.MaxPool2D(pool_size=3, strides=2)

    def forward(self, x):
        return torch.cat([self.c3(x), self.c3d(x), self.pool(x)], dim=1)


def _make_B(c7):
    return _Branches([
        _conv(192, 1),
        _seq(_conv(c7, 1), _conv(c7, (1, 7), pad=(0, 3)),
             _conv(192, (7, 1), pad=(3, 0))),
        _seq(_conv(c7, 1), _conv(c7, (7, 1), pad=(3, 0)),
             _conv(c7, (1, 7), pad=(0, 3)), _conv(c7, (7, 1), pad=(3, 0)),
             _conv(192, (1, 7), pad=(0, 3))),
        _pool_branch(192),
    ])


class _ReductionB(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.b1 = _seq(_conv(192, 1), _conv(320, 3, stride=2))
        self.b2 = _seq(_conv(192, 1), _conv(192, (1, 7), pad=(0, 3)),
                       _conv(192, (7, 1), pad=(3, 0)),
                       _conv(192, 3, stride=2))
        self.pool = nn.MaxPool2D(pool_size=3, strides=2)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.pool(x)], dim=1)


class _InceptionC(HybridBlock):
    """8x8 block: the 3x3 branches split into parallel 1x3/3x1 halves."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.b0 = _conv(320, 1)
        self.b1_stem = _conv(384, 1)
        self.b1_a = _conv(384, (1, 3), pad=(0, 1))
        self.b1_b = _conv(384, (3, 1), pad=(1, 0))
        self.b2_stem = _seq(_conv(448, 1), _conv(384, 3, pad=1))
        self.b2_a = _conv(384, (1, 3), pad=(0, 1))
        self.b2_b = _conv(384, (3, 1), pad=(1, 0))
        self.bp = _pool_branch(192)

    def forward(self, x):
        s1 = self.b1_stem(x)
        s2 = self.b2_stem(x)
        return torch.cat([self.b0(x), self.b1_a(s1), self.b1_b(s1),
                          self.b2_a(s2), self.b2_b(s2), self.bp(x)], dim=1)


class Inception3(HybridBlock):
    """Inception v3 (299x299 canonical input; 75 pixels and up work)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(
            _conv(32, 3, stride=2),
            _conv(32, 3),
            _conv(64, 3, pad=1),
            nn.MaxPool2D(pool_size=3, strides=2),
            _conv(80, 1),
            _conv(192, 3),
            nn.MaxPool2D(pool_size=3, strides=2),
            _make_A(32), _make_A(64), _make_A(64),
            _ReductionA(),
            _make_B(128), _make_B(160), _make_B(160), _make_B(192),
            _ReductionB(),
            _InceptionC(), _InceptionC(),
            nn.GlobalAvgPool2D(),
            nn.Dropout(0.5),
            nn.Flatten(),
        )
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(**kwargs):
    return Inception3(**kwargs)
