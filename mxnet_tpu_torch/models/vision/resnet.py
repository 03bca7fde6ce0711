"""ResNet v1 and v2 (counterpart of ``mxnet_tpu/models/vision/resnet.py``,
after MXNet's ``gluon/model_zoo/vision/resnet.py``): the same blocks,
layer counts and structural parameter names, so one parameter file
serves both packages.  Every constructor takes ``layout="NHWC"``: the
data is channels-last end to end (cuDNN's native format), BatchNorm
runs on axis -1, and the weights stay (O, I, kH, kW), so a checkpoint
moves between layouts unchanged.
"""
from __future__ import annotations

import torch

from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _bn_axis(layout):
    return -1 if layout[-1] == "C" else 1


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _downsample(channels, stride, in_channels, layout):
    """v1's projection shortcut: a strided 1x1 convolution and BatchNorm."""
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                      use_bias=False, in_channels=in_channels,
                      layout=layout))
    out.add(nn.BatchNorm(axis=_bn_axis(layout)))
    return out


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample(channels, stride, in_channels,
                                      layout) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample(channels, stride, in_channels,
                                      layout) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            layout=layout) if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = torch.relu(self.bn2(self.conv1(x)))
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False,
                               layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False, layout=layout)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            layout=layout) if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = torch.relu(self.bn2(self.conv1(x)))
        x = torch.relu(self.bn3(self.conv2(x)))
        return self.conv3(x) + residual


class _ResNet(HybridBlock):
    """``features`` (stem, one stage per entry of ``layers``, pooling)
    and the ``output`` Dense; v1 and v2 differ in the stem, the blocks
    and the pre-pooling norm."""

    _v2 = False

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError(f"{len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{len(channels)}")
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential()
        if self._v2:
            self.features.add(nn.BatchNorm(axis=ax, scale=False,
                                           center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                in_channels=channels[i]))
        if self._v2:
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, in_channels=0):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=self._layout))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=self._layout))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """Post-activation ResNet (conv → BN → ReLU)."""


class ResNetV2(_ResNet):
    """Pre-activation ResNet: a scale- and shift-free BatchNorm on the
    input, BN → ReLU → conv blocks, and BN → ReLU before pooling."""

    _v2 = True


_resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_v1_blocks = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}
_v2_blocks = {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101,
    152); ``kwargs`` go to the network (``classes``, ``thumbnail``,
    ``layout``)."""
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no model download); "
            "load_parameters() a checkpoint instead")
    block_type, layers, channels = _resnet_spec[num_layers]
    if version == 1:
        return ResNetV1(_v1_blocks[block_type], layers, channels, **kwargs)
    return ResNetV2(_v2_blocks[block_type], layers, channels, **kwargs)


def _make(version, n):
    def f(**kwargs):
        return get_resnet(version, n, **kwargs)
    f.__name__ = f"resnet{n}_v{version}"
    return f


resnet18_v1 = _make(1, 18)
resnet34_v1 = _make(1, 34)
resnet50_v1 = _make(1, 50)
resnet101_v1 = _make(1, 101)
resnet152_v1 = _make(1, 152)
resnet18_v2 = _make(2, 18)
resnet34_v2 = _make(2, 34)
resnet50_v2 = _make(2, 50)
resnet101_v2 = _make(2, 101)
resnet152_v2 = _make(2, 152)
