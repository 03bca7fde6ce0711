"""Attention ops and the two CUDA kernels (counterpart of
``mxnet_tpu.ops``)."""
from .attention import dot_product_attention, flash_attention
from .paged import kv_dequantize, kv_quantize, paged_attention

__all__ = ["dot_product_attention", "flash_attention", "paged_attention",
           "kv_quantize", "kv_dequantize"]
