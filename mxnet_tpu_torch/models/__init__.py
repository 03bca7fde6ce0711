"""Models (counterpart of ``mxnet_tpu.models``): GPT-2 for this slice."""
from .gpt2 import GPT2Model, get_gpt2

__all__ = ["GPT2Model", "get_gpt2"]
