"""Gluon core (counterpart of ``mxnet_tpu.gluon``)."""
from . import loss, nn
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Trainer",
           "loss", "nn"]
