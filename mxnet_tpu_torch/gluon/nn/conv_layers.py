"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``), with the reference's signatures,
parameter names (``weight``, ``bias``) and shapes: (O, I/groups, *k)
weights in every layout, (Cin, Cout/groups, *k) for the transposed
convolutions, which run channels-first only.  A 0 ``in_channels`` defers
the weight to the first call, which reads the channel count from the
layout's channel axis.  The layers run the tensor functions of
:mod:`mxnet_tpu_torch.ndarray.ops` (``conv``, ``deconv``, ``pool``); the
convolutions consult the amp cast policy as ``Convolution`` /
``Deconvolution``.
"""
from __future__ import annotations

from ... import amp as _amp
from ... import base as _base
from ...ndarray import ops
from ...ndarray.ops import ACTIVATION_FNS, CHANNELS_LAST_LAYOUTS
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuplify(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, transpose=False,
                 output_padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if transpose and layout in CHANNELS_LAST_LAYOUTS:
            raise _base.MXNetError(
                "channels-last layout is not supported for transpose "
                "convolutions (Deconvolution runs NCHW)")
        self._channels = channels
        self._kernel = _tuplify(kernel_size, ndim)
        self._strides = _tuplify(strides, ndim)
        self._padding = _tuplify(padding, ndim)
        self._dilation = _tuplify(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self._act = ACTIVATION_FNS[activation] if activation else None
        self._transpose = transpose
        self._output_padding = _tuplify(output_padding, ndim)
        self._new_param("weight", self._weight_shape(in_channels),
                        init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self._new_param("bias", (channels,), init=bias_initializer,
                            allow_deferred_init=True)
        else:
            self.bias = None

    def _weight_shape(self, c_in):
        if self._transpose:
            return (c_in, self._channels // self._groups) + self._kernel
        return (self._channels, c_in // self._groups if c_in else 0) \
            + self._kernel

    def infer_shape(self, x, *args):
        c_in = x.shape[-1] if self._layout in CHANNELS_LAST_LAYOUTS \
            else x.shape[1]
        self._set_shape("weight", self._weight_shape(c_in))

    def forward(self, x):
        if self._transpose:
            x, w, b = _amp.cast("Deconvolution", x, self.weight, self.bias)
            out = ops.deconv(x, w, b, self._strides, self._dilation,
                             self._padding, self._groups)
        else:
            x, w, b = _amp.cast("Convolution", x, self.weight, self.bias)
            out = ops.conv(x, w, b, self._strides, self._dilation,
                           self._padding, self._groups, self._layout)
        return out if self._act is None else self._act(out)

    def __repr__(self):
        return (f"{type(self).__name__}({self._channels}, "
                f"kernel_size={self._kernel}, stride={self._strides})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=1,
                         **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=2,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=3,
                         **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=1,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=2,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=3,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True, ndim=2,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kernel = _tuplify(pool_size, ndim)
        self._strides = _tuplify(strides if strides is not None
                                 else pool_size, ndim)
        self._padding = _tuplify(padding, ndim)
        self._ceil = ceil_mode
        self._global = global_pool
        self._pool_type = pool_type
        self._layout = layout
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return ops.pool(x, self._kernel, self._pool_type, self._global,
                        self._strides, self._padding,
                        "full" if self._ceil else "valid",
                        self._count_include_pad, self._layout)

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding})")


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, ndim=1, **kwargs)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, ndim=2, **kwargs)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, ndim=3, **kwargs)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, ndim=1, **kwargs)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, ndim=2, **kwargs)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, ndim=3, **kwargs)


class _GlobalPool(_Pool):
    def __init__(self, pool_type, layout, ndim, **kwargs):
        super().__init__(1, 1, 0, False, True, pool_type, layout, ndim=ndim,
                         **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("max", layout, 1, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("max", layout, 2, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("max", layout, 3, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("avg", layout, 1, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("avg", layout, 2, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("avg", layout, 3, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflect-pad the two spatial axes of NCHW data by ``padding`` (an
    int, or ``nd.pad``'s 8-tuple ``pad_width``)."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
