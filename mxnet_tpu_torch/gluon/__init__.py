"""Gluon core (counterpart of ``mxnet_tpu.gluon``)."""
from . import data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from .utils import split_and_load

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "data", "loss", "model_zoo",
           "nn", "rnn", "utils", "split_and_load"]
