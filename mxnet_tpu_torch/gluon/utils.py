"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
splitting a batch across devices and clipping by the global norm."""
from __future__ import annotations

import math
import warnings
from typing import List

import torch

from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data: NDArray, num_slice: int, batch_axis=0,
               even_split=True) -> List[NDArray]:
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder when ``even_split`` is False."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data size {size} not divisible by {num_slice} slices; set "
            "even_split=False")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch across contexts, one slice on each."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before clipping (a float, or a 0-d
    tensor when ``check_isfinite`` is False)."""
    ts = [a._t for a in arrays]
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in ts))
        scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
        for t in ts:
            t.mul_(scale.to(t.dtype))
    if not check_isfinite:
        return norm
    norm_val = float(norm)
    if not math.isfinite(norm_val):
        warnings.warn("nan or inf found in clip_global_norm")
    return norm_val
