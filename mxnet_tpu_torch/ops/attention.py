"""Attention dispatch (counterpart of ``mxnet_tpu/ops/attention.py``):
the reference attention in plain PyTorch, and the routing that sends
long self-attention on the card to the flash kernels.

``_use_flash`` keeps the reference's shape rule (``attention.py:74``:
self-attention, no mask, T >= 256, T % 128 == 0, D in {64, 128, 256})
and replaces "platform is a TPU" with "the tensor is on CUDA".  On the
CPU the reference path runs.  The flash route is differentiable (B1
forward, B2/B3 backward through ``flash._FlashAttention``), so a
training forward takes it too.  Under ``amp.init()`` both entry points
cast q, k and v as the policy casts ``dot_product_attention`` /
``flash_attention`` (bf16 by default), so the kernels run their bf16
instantiations.  Attention dropout (``dropout``) takes the reference
path, as the reference's ``_use_flash`` rules (``attention.py:61-82``),
and drops only in training, with masks from the device's generator.
"""
from __future__ import annotations

import torch

from .. import amp as _amp
from .. import base as _base
from .. import random as _random
from ..base import MXNetError
from . import dots as _dots

__all__ = ["dot_product_attention", "flash_attention"]

_NEG_INF = -1e30


def _attention_ref(q, k, v, *, causal=False, mask=None, scale=None,
                   dropout=0.0):
    """Plain attention on (B, T, H, D).  Scores in float32; causal is
    bottom-right aligned when tq != tk; fully-masked rows return zeros,
    as the flash kernel's do; ``dropout`` (applied as given: the caller
    passes 0 outside training) drops attention weights."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = _dots.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    tq, tk = logits.shape[-2], logits.shape[-1]
    neg = torch.full_like(logits, _NEG_INF)
    if causal:
        idx_q = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        idx_k = torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(idx_k <= idx_q, logits, neg)
    if mask is not None:
        logits = torch.where(mask, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    if mask is not None or (causal and tq > tk):
        any_valid = (logits > 0.5 * _NEG_INF).any(dim=-1, keepdim=True)
        probs = torch.where(any_valid, probs, torch.zeros_like(probs))
    if dropout > 0.0:
        draw = torch.rand(probs.shape, device=probs.device,
                          generator=_random.generator(probs.device))
        probs = torch.where(draw < 1.0 - dropout, probs / (1.0 - dropout),
                            torch.zeros_like(probs))
    return _dots.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _use_flash(q, k, mask, dropout=0.0) -> bool:
    if mask is not None or dropout > 0.0 or \
            tuple(k.shape) != tuple(q.shape):
        return False
    _b, t, _h, d = q.shape
    if t < 256 or t % 128 or d not in (64, 128, 256):
        return False
    return q.device.type == "cuda"


def flash_attention(q, k, v, *, causal=False, scale=None):
    """Flash kernel on the card for shapes it takes, reference elsewhere."""
    q, k, v = _amp.cast("flash_attention", q, k, v)
    if _use_flash(q, k, None):
        from .flash import flash_attention as _flash
        return _flash(q, k, v, causal=causal, scale=scale)
    return _attention_ref(q, k, v, causal=causal, scale=scale)


def dot_product_attention(query, key, value, *, causal=False, mask=None,
                          segment_ids=None, kv_segment_ids=None,
                          dropout=0.0, scale=None, impl="auto"):
    """Multi-head attention on tensors: (B, T, H, D) → (B, T, H, D).

    ``impl``: ``'auto'`` takes the flash kernels where they apply (see
    ``_use_flash``) and the reference path elsewhere; ``'flash'`` raises
    where they do not apply; ``'ref'`` always takes the reference path.
    ``segment_ids`` (B, Tq) enables sequence packing (``kv_segment_ids``
    (B, Tk) defaults to it).  A query whose keys are all masked returns
    zeros on both paths.  ``dropout`` drops attention weights in
    training, on the reference path."""
    if impl not in ("auto", "flash", "ref"):
        raise MXNetError(f"impl={impl!r}: expected 'auto', 'flash' or "
                         "'ref'")
    query, key, value = _amp.cast("dot_product_attention", query, key,
                                  value)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg = torch.as_tensor(segment_ids, device=query.device)
        kv_seg = q_seg if kv_segment_ids is None else torch.as_tensor(
            kv_segment_ids, device=query.device)
        b, tq, tk = query.shape[0], query.shape[1], key.shape[1]
        if tuple(q_seg.shape) != (b, tq) or tuple(kv_seg.shape) != (b, tk):
            raise MXNetError(
                f"segment_ids must be (B, Tq)=({b}, {tq}) and "
                f"kv_segment_ids (B, Tk)=({b}, {tk}); got "
                f"{tuple(q_seg.shape)} / {tuple(kv_seg.shape)}")
    elif kv_segment_ids is not None:
        raise MXNetError("kv_segment_ids requires segment_ids")
    if impl == "flash" and (mask is not None or dropout > 0.0):
        raise MXNetError("impl='flash' does not support an explicit mask "
                         "or attention dropout — use impl='auto'/'ref'")
    if impl == "flash" and not _use_flash(query, key, mask):
        raise MXNetError(
            f"impl='flash' requested but the flash kernels do not take "
            f"this configuration (shape={tuple(query.shape)}, key shape="
            f"{tuple(key.shape)}, device={query.device}): self-attention "
            "with T >= 256, T % 128 == 0 and D in (64, 128, 256) on a CUDA "
            "device — use impl='auto' to fall back to the reference path")
    if impl != "ref" and _use_flash(query, key, mask, dropout):
        from .flash import flash_attention as _flash
        return _flash(query, key, value, causal=causal, scale=scale,
                      segment_ids=q_seg, kv_segment_ids=kv_seg)
    full_mask = mask
    if q_seg is not None:
        seg_mask = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        full_mask = seg_mask if mask is None else (mask & seg_mask)
    return _attention_ref(query, key, value, causal=causal, mask=full_mask,
                          scale=scale,
                          dropout=dropout if _base.is_training() else 0.0)


# MXNet's fused self-attention ops live in ``nd``; re-exported here as the
# reference's ``ops`` namespace does
from ..ndarray.ops import (interleaved_matmul_selfatt_qk,  # noqa: E402,F401
                           interleaved_matmul_selfatt_valatt)
