"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

Mirrors the JAX package's layout and names.  It carries MXNet's
imperative surface (``nd``, ``autograd``, ``init``, ``amp``, and
``gluon`` with its blocks, layers, ``Trainer`` and ``loss``), the serving
path (GPT-2 through ``InferenceEngine``) and the
training path (GPT-2 through ``gluon.Trainer`` or
``parallel.ShardedTrainer`` with the registered optimizers), with
hand-written CUDA kernels for flash attention forward and backward and
for paged attention.  Entry points run on the current CUDA device unless
the caller asks for the CPU (``device="cpu"``, ``ctx=mx.cpu()`` or
``with mx.cpu():``); without a card they raise.
"""
from . import (amp, analysis, autograd, base, context, gluon, initializer,
               lr_scheduler, models, ndarray, observability, ops, optimizer,
               parallel, profiler, random, resilience, serving)
from . import data, io, recordio  # the input pipeline, over the above
from . import initializer as init
from . import ndarray as nd
from .base import MXNetError
from .context import (Context, Device, cpu, cpu_pinned, current_context,
                      current_device, gpu, num_gpus)

__all__ = ["MXNetError", "Context", "Device", "cpu", "gpu", "cpu_pinned",
           "num_gpus", "current_context", "current_device", "amp",
           "analysis", "autograd", "base", "context", "data", "gluon",
           "init", "initializer", "io", "lr_scheduler", "models", "nd",
           "ndarray", "observability", "ops", "optimizer", "parallel",
           "profiler", "random", "recordio", "resilience", "serving"]
