"""Models (counterpart of ``mxnet_tpu.models``): GPT-2 and its LM loss,
the stacked GPT-2 of pipeline parallelism, the MoE layers, BERT with its pretraining heads, Transformer NMT and
its loss, and the vision zoo (``vision``, ``get_model``)."""
from . import vision
from .bert import BERTForPretrain, BERTModel, get_bert
from .gpt2 import GPT2Model, get_gpt2, gpt2_lm_loss
from .moe import (MoELayer, MoETransformerBlock, aux_loss_scope, moe_ffn,
                  pop_aux_losses)
from .nmt import TransformerDecoderBlock, TransformerNMT, get_nmt, nmt_loss
from .stacked import StackedGPT2Model, get_stacked_gpt2
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerBlock, TransformerEncoderLayer)
from .vision import get_model

__all__ = ["vision", "get_model", "GPT2Model", "get_gpt2", "gpt2_lm_loss",
           "MoELayer", "MoETransformerBlock", "moe_ffn", "pop_aux_losses",
           "aux_loss_scope", "get_bert", "BERTModel", "BERTForPretrain",
           "get_nmt", "TransformerNMT", "TransformerDecoderBlock",
           "nmt_loss", "StackedGPT2Model", "get_stacked_gpt2",
           "MultiHeadAttention", "PositionwiseFFN",
           "TransformerBlock", "TransformerEncoderLayer"]
