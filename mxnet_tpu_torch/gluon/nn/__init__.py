"""Neural-network layers (counterpart of ``mxnet_tpu.gluon.nn``)."""
from .basic_layers import GELU, Dense, Dropout, Embedding, LayerNorm

__all__ = ["Dense", "Embedding", "LayerNorm", "GELU", "Dropout"]
