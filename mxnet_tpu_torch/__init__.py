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
``with mx.cpu():``); without a card they raise.  The symbolic surface
(``mx.sym``, ``mx.mod`` with ``metric``/``callback``/``model``/
``monitor``/``viz``, ``subgraph``, ``onnx``, ``name``, ``attribute``),
``np`` / ``npx``, ``image``, ``util``, ``test_utils``, ``runtime``,
``engine`` and ``rtc`` are imported at first use, as in the reference.
"""
from . import (amp, analysis, autograd, base, context, gluon, initializer,
               lr_scheduler, models, ndarray, observability, ops, optimizer,
               parallel, profiler, random, resilience, serving)
from . import data, io, recordio  # the input pipeline, over the above
from . import kvstore
from . import kvstore as kv
from . import initializer as init
from . import ndarray as nd
from .base import MXNetError
from .context import (Context, Device, cpu, cpu_pinned, current_context,
                      current_device, gpu, num_gpus)

__all__ = ["MXNetError", "Context", "Device", "cpu", "gpu", "cpu_pinned",
           "num_gpus", "current_context", "current_device", "amp",
           "analysis", "autograd", "base", "context", "data", "gluon",
           "init", "initializer", "io", "kv", "kvstore", "lr_scheduler",
           "models", "nd",
           "ndarray", "observability", "ops", "optimizer", "parallel",
           "profiler", "random", "recordio", "resilience", "serving"]

# the symbolic surface, imported at first use (the reference's lazy
# names, ``mxnet_tpu/__init__.py``)
_LAZY = {
    "sym": ".symbol", "symbol": ".symbol", "mod": ".module",
    "module": ".module", "metric": ".metric", "callback": ".callback",
    "model": ".model", "monitor": ".monitor", "mon": ".monitor",
    "viz": ".visualization", "visualization": ".visualization",
    "subgraph": ".subgraph", "onnx": ".onnx", "name": ".name",
    "attribute": ".attribute", "np": ".numpy", "npx": ".numpy_extension",
    "numpy": ".numpy", "numpy_extension": ".numpy_extension",
    "image": ".image", "util": ".util", "test_utils": ".test_utils",
    "runtime": ".runtime", "engine": ".engine", "rtc": ".rtc",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxnet_tpu_torch' has no attribute "
                         f"{name!r}")
