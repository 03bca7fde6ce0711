"""Attention dispatch (counterpart of ``mxnet_tpu/ops/attention.py``):
the reference attention in plain PyTorch, and the routing that sends
long self-attention on the card to the flash kernel.

``_use_flash`` keeps the reference's shape rule (``attention.py:74``:
self-attention, no mask, T >= 256, T % 128 == 0, D in {64, 128, 256})
and replaces "platform is a TPU" with "the tensor is on CUDA".  On the
CPU the reference path runs.  Attention dropout is not ported (GPT-2
serving runs none).
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["dot_product_attention", "flash_attention"]

_NEG_INF = -1e30


def _attention_ref(q, k, v, *, causal=False, mask=None, scale=None):
    """Plain attention on (B, T, H, D).  Scores in float32; causal is
    bottom-right aligned when tq != tk; fully-masked rows return zeros,
    as the flash kernel's do."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
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
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _use_flash(q, k, mask) -> bool:
    if mask is not None or tuple(k.shape) != tuple(q.shape):
        return False
    _b, t, _h, d = q.shape
    if t < 256 or t % 128 or d not in (64, 128, 256):
        return False
    return q.device.type == "cuda"


def flash_attention(q, k, v, *, causal=False, scale=None):
    """Flash kernel on the card for shapes it takes, reference elsewhere."""
    if _use_flash(q, k, None):
        from .flash import flash_attention as _flash
        return _flash(q, k, v, causal=causal, scale=scale)
    return _attention_ref(q, k, v, causal=causal, scale=scale)


def dot_product_attention(query, key, value, *, causal=False, mask=None,
                          segment_ids=None, kv_segment_ids=None,
                          scale=None):
    """Multi-head attention on tensors: (B, T, H, D) → (B, T, H, D).

    ``segment_ids`` (B, Tq) enables sequence packing (``kv_segment_ids``
    (B, Tk) defaults to it).  A query whose keys are all masked returns
    zeros on both paths."""
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
    if _use_flash(query, key, mask):
        from .flash import flash_attention as _flash
        return _flash(query, key, value, causal=causal, scale=scale,
                      segment_ids=q_seg, kv_segment_ids=kv_seg)
    full_mask = mask
    if q_seg is not None:
        seg_mask = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        full_mask = seg_mask if mask is None else (mask & seg_mask)
    return _attention_ref(query, key, value, causal=causal, mask=full_mask,
                          scale=scale)
