"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``;
parity: python/mxnet/runtime.py + src/libinfo.cc).

The feature names are the reference's.  Each reflects what this process
has: ``CUDA`` is torch's (a card is visible), ``TPU`` and ``PALLAS`` are
False (the port runs no TPU and no Pallas kernel), ``DIST_KVSTORE`` is
``torch.distributed``, ``NATIVE_IO`` whether the native reader
library builds and loads.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

__all__ = ["Feature", "Features", "feature_list"]

Feature = namedtuple("Feature", ["name", "enabled"])


def _detect():
    import torch

    feats = OrderedDict()

    def add(name, enabled):
        feats[name] = Feature(name, bool(enabled))

    add("TPU", False)
    add("CUDA", torch.cuda.is_available())
    add("CPU", True)
    add("CPU_SSE", True)
    add("BLAS_OPEN", True)
    add("F16C", True)
    add("BF16", True)
    add("INT64_TENSOR_SIZE", False)
    add("SIGNAL_HANDLER", False)
    add("PROFILER", True)            # torch.profiler
    add("PALLAS", False)
    add("DIST_KVSTORE", torch.distributed.is_available())
    try:
        from .utils import native_io
        add("NATIVE_IO", native_io.available())
    except Exception:    # the reader does not build here: absent
        add("NATIVE_IO", False)
    add("ONEDNN", False)
    add("TENSORRT", False)
    add("OPENCV", False)             # PIL-backed image path instead
    return feats


class Features(OrderedDict):
    """Mapping of feature name → Feature (parity: mx.runtime.Features)."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            cls.instance = super().__new__(cls)
            OrderedDict.__init__(cls.instance, _detect())
        return cls.instance

    def __init__(self):
        pass

    def __repr__(self):
        return f"[{', '.join(self.keys())}]"

    def is_enabled(self, name):
        return self[name].enabled


def feature_list():
    return list(Features().values())
