"""Attention ops and the CUDA kernels' wrappers (counterpart of
``mxnet_tpu.ops``).  Importing the package registers every wrapper's
launch counters (``launches``)."""
from . import flash, launches
from .attention import (dot_product_attention, flash_attention,
                        interleaved_matmul_selfatt_qk,
                        interleaved_matmul_selfatt_valatt)
from .paged import kv_dequantize, kv_quantize, paged_attention

__all__ = ["dot_product_attention", "flash_attention",
           "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt", "paged_attention",
           "kv_quantize", "kv_dequantize"]
