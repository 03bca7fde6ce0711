"""Gluon core (counterpart of ``mxnet_tpu.gluon``)."""
from . import nn
from .block import Block, HybridBlock

__all__ = ["Block", "HybridBlock", "nn"]
