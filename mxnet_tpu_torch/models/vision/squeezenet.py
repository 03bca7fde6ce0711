"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxnet_tpu/models/vision/squeezenet.py``): fire modules and the two
versions' layouts, with ``ceil_mode`` pooling (the ``full``
convention)."""
from __future__ import annotations

import torch

from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze, kernel_size=1, activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3, kernel_size=3, padding=1,
                                   activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1x1(x), self.expand3x3(x)], dim=1)


def _pool():
    return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(
                nn.Conv2D(96, kernel_size=7, strides=2, activation="relu"),
                _pool(), _Fire(16, 64, 64), _Fire(16, 64, 64),
                _Fire(32, 128, 128), _pool(), _Fire(32, 128, 128),
                _Fire(48, 192, 192), _Fire(48, 192, 192),
                _Fire(64, 256, 256), _pool(), _Fire(64, 256, 256))
        elif version == "1.1":
            self.features.add(
                nn.Conv2D(64, kernel_size=3, strides=2, activation="relu"),
                _pool(), _Fire(16, 64, 64), _Fire(16, 64, 64), _pool(),
                _Fire(32, 128, 128), _Fire(32, 128, 128), _pool(),
                _Fire(48, 192, 192), _Fire(48, 192, 192),
                _Fire(64, 256, 256), _Fire(64, 256, 256))
        else:
            raise ValueError(f"unsupported SqueezeNet version {version}")
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1,
                                  activation="relu"),
                        nn.GlobalAvgPool2D(),
                        nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet("1.1", **kw)
