"""``mx.rtc`` (counterpart of ``mxnet_tpu/rtc.py``; parity surface:
python/mxnet/rtc.py).

Upstream compiles CUDA source at run time (``CudaModule`` over NVRTC).
The reference has no such path and raises; the port raises as it does:
its CUDA kernels are sources under ``mxnet_tpu_torch/csrc/``, built by
``nvcc`` (``utils/native.py``) and bound through ctypes, so a kernel is
added there, not compiled from a string at run time.
"""
from __future__ import annotations

from . import base as _base

__all__ = ["CudaModule", "CudaKernel"]

_MSG = ("mx.rtc compiles CUDA source at run time, which this build does "
        "not do: the port's kernels are CUDA sources under "
        "mxnet_tpu_torch/csrc/ (flash_fwd.cu, flash_bwd.cu, "
        "flash_dq_ring.cu, paged_attention.cu), built by nvcc through "
        "mxnet_tpu_torch/utils/native.py; add a kernel there, or write the "
        "op with torch functions (mxnet_tpu_torch.autograd.Function).")


class CudaModule:
    def __init__(self, *a, **kw):
        raise _base.MXNetError(_MSG)


class CudaKernel:
    def __init__(self, *a, **kw):
        raise _base.MXNetError(_MSG)
