"""Gluon core (counterpart of ``mxnet_tpu.gluon``)."""
from . import data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from .utils import split_and_load

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterDict", "Constant", "DeferredInitializationError",
           "Trainer", "data", "loss", "model_zoo", "nn", "rnn", "utils",
           "split_and_load"]


def __getattr__(name):
    # gluon.contrib (Concurrent, the estimator) resolves at first use, as
    # the reference's does
    if name == "contrib":
        import importlib
        mod = importlib.import_module(".contrib", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxnet_tpu_torch.gluon' has no attribute "
                         f"{name!r}")
