"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/models/vision/densenet.py``): the same growth-rate and
block tables and dense/transition structure."""
from __future__ import annotations

import torch

from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

# num_init_features, growth_rate, block_config
_SPEC = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False),
                      nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.body(x)
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


def _transition(num_output):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(num_output, kernel_size=1, use_bias=False),
            nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                      padding=3, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.MaxPool2D(pool_size=3, strides=2, padding=1))
        channels = num_init_features
        for i, n in enumerate(block_config):
            block = nn.HybridSequential()
            for _ in range(n):
                block.add(_DenseLayer(growth_rate, bn_size, dropout))
            self.features.add(block)
            channels += n * growth_rate
            if i != len(block_config) - 1:
                channels //= 2
                self.features.add(_transition(channels))
        self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                          nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _make(n):
    def f(**kw):
        init, growth, cfg = _SPEC[n]
        return DenseNet(init, growth, cfg, **kw)
    f.__name__ = f"densenet{n}"
    return f


densenet121 = _make(121)
densenet161 = _make(161)
densenet169 = _make(169)
densenet201 = _make(201)
