"""``mx.library``: extension loading (counterpart of
``mxnet_tpu/library.py``).

An extension is a Python module whose top level registers custom ops
(``mx.operator.register``) or other entries, or a shared library opened
with ``RTLD_GLOBAL`` whose ``mxnet_tpu_init`` entry point, where it has
one, is called with no arguments: the reference's symbol, so one
extension loads into either package.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import sys

import torch

from . import base as _base

__all__ = ["load", "compiled_with_cxx11_abi"]

_loaded = {}


def load(path, verbose=True):
    """Load the extension at ``path`` (``.py``, ``.so`` or ``.dylib``)
    once; returns its module or library handle."""
    path = os.path.abspath(path)
    if path in _loaded:
        return _loaded[path]
    if not os.path.exists(path):
        raise _base.MXNetError(f"library not found: {path}")
    if path.endswith(".py"):
        name = "mxnet_tpu_torch_ext_" + \
            os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _loaded[path] = mod
        return mod
    if path.endswith((".so", ".dylib")):
        lib = ctypes.CDLL(path, ctypes.RTLD_GLOBAL)
        if hasattr(lib, "mxnet_tpu_init"):
            lib.mxnet_tpu_init()
        _loaded[path] = lib
        return lib
    raise _base.MXNetError(
        f"unsupported extension type: {path} (.py, .so or .dylib)")


def compiled_with_cxx11_abi():
    """Whether the torch this package runs on was built with the C++11
    ABI (an extension's C++ must match it)."""
    return bool(torch.compiled_with_cxx11_abi())
