"""Neural-network layers (counterpart of ``mxnet_tpu.gluon.nn``)."""
from ..block import Block, HybridBlock
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _layers
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_layers

__all__ = ["Block", "HybridBlock", *_layers, *_conv_layers]
