"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

Mirrors the JAX package's layout and names.  It carries the serving
path (GPT-2 through ``InferenceEngine``) and the training path (GPT-2
through ``parallel.ShardedTrainer`` with the registered optimizers),
with hand-written CUDA kernels for flash attention forward and backward
and for paged attention.  Entry points run on the current CUDA device
unless the caller passes ``device="cpu"``; without a card they raise.
"""
from . import (amp, base, context, gluon, initializer, lr_scheduler, models,
               ops, optimizer, parallel, random, serving)
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "cpu", "gpu", "amp", "base", "context", "gluon",
           "initializer", "lr_scheduler", "models", "ops", "optimizer",
           "parallel", "random", "serving"]
