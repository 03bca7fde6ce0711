"""AlexNet (counterpart of ``mxnet_tpu/models/vision/alexnet.py``): the
same ``features``/``output`` split and layer order."""
from __future__ import annotations

from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(64, kernel_size=11, strides=4, padding=2,
                      activation="relu"),
            nn.MaxPool2D(pool_size=3, strides=2),
            nn.Conv2D(192, kernel_size=5, padding=2, activation="relu"),
            nn.MaxPool2D(pool_size=3, strides=2),
            nn.Conv2D(384, kernel_size=3, padding=1, activation="relu"),
            nn.Conv2D(256, kernel_size=3, padding=1, activation="relu"),
            nn.Conv2D(256, kernel_size=3, padding=1, activation="relu"),
            nn.MaxPool2D(pool_size=3, strides=2),
            nn.Flatten(),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(**kwargs):
    return AlexNet(**kwargs)
