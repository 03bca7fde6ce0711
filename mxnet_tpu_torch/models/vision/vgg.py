"""VGG 11/13/16/19 and their BatchNorm variants (counterpart of
``mxnet_tpu/models/vision/vgg.py``): the same spec tables and
``features``/``output`` split."""
from __future__ import annotations

from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

_SPEC = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        for n, f in zip(layers, filters):
            for _ in range(n):
                self.features.add(nn.Conv2D(f, kernel_size=3, padding=1))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(strides=2))
        self.features.add(nn.Flatten(),
                          nn.Dense(4096, activation="relu"),
                          nn.Dropout(0.5),
                          nn.Dense(4096, activation="relu"),
                          nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, **kwargs):
    layers, filters = _SPEC[num_layers]
    return VGG(layers, filters, **kwargs)


def _make(n, batch_norm):
    def f(**kw):
        return get_vgg(n, batch_norm=batch_norm, **kw)
    f.__name__ = f"vgg{n}{'_bn' if batch_norm else ''}"
    return f


vgg11 = _make(11, False)
vgg13 = _make(13, False)
vgg16 = _make(16, False)
vgg19 = _make(19, False)
vgg11_bn = _make(11, True)
vgg13_bn = _make(13, True)
vgg16_bn = _make(16, True)
vgg19_bn = _make(19, True)
