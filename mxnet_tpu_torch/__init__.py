"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

Mirrors the JAX package's layout and names; this slice carries the
serving path: GPT-2 through ``InferenceEngine``, with hand-written CUDA
kernels for flash-attention forward (prefill) and paged attention
(decode).  Entry points run on the current CUDA device unless the
caller passes ``device="cpu"``; without a card they raise.
"""
from . import base, context, gluon, initializer, models, ops, serving
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "cpu", "gpu", "base", "context",
           "gluon", "initializer", "models", "ops", "serving"]
