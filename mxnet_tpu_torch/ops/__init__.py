"""Attention ops and the CUDA kernels' wrappers (counterpart of
``mxnet_tpu.ops``).  Importing the package registers every wrapper's
launch counters (``launches``).  The sequence-parallel ops (``ring``,
``ulysses``) load at first use: they build on ``parallel``, which
imports this package."""
from . import flash, launches
from .attention import (dot_product_attention, flash_attention,
                        interleaved_matmul_selfatt_qk,
                        interleaved_matmul_selfatt_valatt)
from .paged import kv_dequantize, kv_quantize, paged_attention

__all__ = ["dot_product_attention", "flash_attention",
           "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt", "paged_attention",
           "kv_quantize", "kv_dequantize", "ring_attention",
           "nd_ring_attention", "ulysses_attention", "nd_ulysses_attention"]


_LAZY = {"ring_attention": "ring", "nd_ring_attention": "ring",
         "ulysses_attention": "ulysses", "nd_ulysses_attention": "ulysses"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
