"""Models (counterpart of ``mxnet_tpu.models``): GPT-2 and its LM loss."""
from .gpt2 import GPT2Model, get_gpt2, gpt2_lm_loss

__all__ = ["GPT2Model", "get_gpt2", "gpt2_lm_loss"]
