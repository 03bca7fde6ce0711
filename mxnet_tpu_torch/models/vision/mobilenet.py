"""MobileNet v1 (width multipliers) and v2 (counterpart of
``mxnet_tpu/models/vision/mobilenet.py``): depthwise-separable and
inverted-residual blocks; a depthwise convolution is a Conv2D with
``groups`` equal to its channels."""
from __future__ import annotations

import torch

from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


class RELU6(HybridBlock):
    """relu6 = clip(x, 0, 6), v2's activation."""

    def forward(self, x):
        return torch.clamp(x, 0.0, 6.0)


def _conv_block(out, kernel, stride, pad, groups=1, act=True, relu6=False):
    # v1 uses plain ReLU and v2 relu6, as MXNet's model zoo does
    seq = nn.HybridSequential()
    seq.add(nn.Conv2D(out, kernel_size=kernel, strides=stride, padding=pad,
                      groups=groups, use_bias=False))
    seq.add(nn.BatchNorm())
    if act:
        seq.add(RELU6() if relu6 else nn.Activation("relu"))
    return seq


def _width(multiplier):
    return lambda ch: max(8, int(ch * multiplier))


class MobileNet(HybridBlock):
    """v1: a 3x3 stem and 13 depthwise-separable blocks."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        c = _width(multiplier)
        spec = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                (512, 2)] + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
        self.features = nn.HybridSequential()
        self.features.add(_conv_block(c(32), 3, 2, 1))
        in_ch = c(32)
        for out, stride in spec:
            # depthwise 3x3, then pointwise 1x1
            self.features.add(_conv_block(in_ch, 3, stride, 1,
                                          groups=in_ch))
            self.features.add(_conv_block(c(out), 1, 1, 0))
            in_ch = c(out)
        self.features.add(nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _InvertedResidual(HybridBlock):
    def __init__(self, in_ch, out_ch, stride, expansion, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_ch == out_ch
        mid = in_ch * expansion
        self.body = nn.HybridSequential()
        if expansion != 1:
            self.body.add(_conv_block(mid, 1, 1, 0, relu6=True))
        self.body.add(_conv_block(mid, 3, stride, 1, groups=mid,
                                  relu6=True))
        self.body.add(_conv_block(out_ch, 1, 1, 0, act=False))

    def forward(self, x):
        out = self.body(x)
        return x + out if self.use_shortcut else out


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        c = _width(multiplier)
        # t (expansion), c (channels), n (repeats), s (stride)
        spec = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                (6, 320, 1, 1)]
        self.features = nn.HybridSequential()
        self.features.add(_conv_block(c(32), 3, 2, 1, relu6=True))
        in_ch = c(32)
        for t, ch, n, s in spec:
            for i in range(n):
                self.features.add(_InvertedResidual(
                    in_ch, c(ch), s if i == 0 else 1, t))
                in_ch = c(ch)
        last = 1280 if multiplier <= 1.0 else c(1280)
        self.features.add(_conv_block(last, 1, 1, 0, relu6=True))
        self.features.add(nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _make(cls, mult, name):
    def f(**kw):
        return cls(mult, **kw)
    f.__name__ = name
    return f


mobilenet1_0 = _make(MobileNet, 1.0, "mobilenet1_0")
mobilenet0_75 = _make(MobileNet, 0.75, "mobilenet0_75")
mobilenet0_5 = _make(MobileNet, 0.5, "mobilenet0_5")
mobilenet0_25 = _make(MobileNet, 0.25, "mobilenet0_25")
mobilenet_v2_1_0 = _make(MobileNetV2, 1.0, "mobilenet_v2_1_0")
mobilenet_v2_0_75 = _make(MobileNetV2, 0.75, "mobilenet_v2_0_75")
mobilenet_v2_0_5 = _make(MobileNetV2, 0.5, "mobilenet_v2_0_5")
mobilenet_v2_0_25 = _make(MobileNetV2, 0.25, "mobilenet_v2_0_25")
