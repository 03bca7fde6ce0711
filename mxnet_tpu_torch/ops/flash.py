"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version (counterpart of ``mxnet_tpu/ops/flash.py``).

The public entry takes (B, T, H, D) and returns O in the same layout;
:func:`flash_fwd` also returns the per-row logsumexp, (B*H, 1, T)
float32 as the reference lays it out, for the backward of a later slice.
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, the analogue of Pallas interpret mode.  The kernel reads
the (B, T, H, D) layout in place through its strides, so no transpose is
made here.

Semantics shared by both versions: scores in float32; causal keeps keys
col <= row (tq == tk); packed segment ids mask keys of other segments;
the masked-safe exp zeroes masked entries; a row with no valid key gets
O = 0 and lse = -1e30; the probabilities are rounded to the value dtype
before the P.V product, as the reference's ``p.astype(v.dtype)`` does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_fwd"]

_MASK = -1e30
_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _fwd_plain(q, k, v, q_seg, kv_seg, causal, scale):
    """Masked softmax attention with the kernel's zero-row and lse rules:
    (O (B, T, H, D) in q's dtype, lse (B*H, 1, T) float32)."""
    b, tq, h, _d = q.shape
    tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None]
    if q_seg is not None:
        keep = keep & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    s = torch.where(keep, s, torch.full_like(s, _MASK))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= _MASK * 0.5, torch.zeros_like(s), torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    empty = l <= 0.0
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = torch.where(empty, torch.zeros_like(pv),
                      pv / torch.where(empty, torch.ones_like(l), l))
    lse = torch.where(empty, torch.full_like(l, _MASK),
                      m + torch.log(torch.where(empty, torch.ones_like(l),
                                                l)))
    return (out.permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(b * h, 1, tq))


def _kernel_fn():
    from ..utils import native
    fn = native.load("flash_fwd").mxt_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                       i, p]
        fn.restype = i
    return fn


def _check_cuda(q, k, v, q_seg, kv_seg):
    if not (k.device == q.device and v.device == q.device):
        raise MXNetError("flash_fwd: q, k, v must share one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"flash_fwd: q, k, v must all be float32 or "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(f"flash_fwd: q, k, v must be one (B, T, H, D) "
                         f"shape, got {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    if q.shape[3] not in _HEAD_DIMS:
        raise MXNetError(f"flash_fwd: head dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_fwd: q, k, v must be contiguous")
    if q.shape[0] * q.shape[2] > 65535:
        raise MXNetError("flash_fwd: batch*heads exceeds the grid limit")
    for seg in (q_seg, kv_seg):
        if seg is not None and (seg.device != q.device
                                or seg.dtype != torch.int32
                                or tuple(seg.shape) != tuple(q.shape[:2])
                                or not seg.is_contiguous()):
            raise MXNetError("flash_fwd: segment ids must be contiguous "
                             "(B, T) int32 on q's device")


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, *, causal: bool,
              scale: float):
    """(O, lse) of self-attention over (B, T, H, D) inputs.  CUDA tensors
    launch ``csrc/flash_fwd.cu`` (counted in ``flash_fwd.launches``);
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, q_seg, kv_seg, causal, scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_fwd: unsupported device {q.device}")
    _check_cuda(q, k, v, q_seg, kv_seg)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, 1, t), dtype=torch.float32, device=q.device)
    from ..utils.native import stream_ptr
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_seg.data_ptr() if q_seg is not None else None,
        kv_seg.data_ptr() if kv_seg is not None else None,
        out.data_ptr(), lse.data_ptr(), b, t, h, d, int(bool(causal)),
        float(scale), _DTYPE_CODE[q.dtype], stream_ptr(q.device))
    if err:
        raise MXNetError(f"flash_fwd: kernel launch failed (cudaError {err})")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    segment_ids=None, kv_segment_ids=None):
    """Flash attention on (B, T, H, D) inputs → (B, T, H, D).

    ``segment_ids`` (B, T) int enables sequence packing: tokens attend
    only within their own segment; ``kv_segment_ids`` defaults to it.
    Rows with no matching key output zeros, as the reference path
    (``attention._attention_ref``) does."""
    b, tq, _h, d = q.shape
    tk = k.shape[1]
    if causal and tq != tk:
        raise ValueError("causal flash attention requires tq == tk "
                         f"(got {tq} vs {tk})")
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg = torch.as_tensor(segment_ids, device=q.device).to(
            torch.int32).contiguous()
        kv_seg = q_seg if kv_segment_ids is None else torch.as_tensor(
            kv_segment_ids, device=q.device).to(torch.int32).contiguous()
        if tuple(q_seg.shape) != (b, tq) or tuple(kv_seg.shape) != (b, tk):
            raise ValueError(f"segment_ids must be (B, Tq)=({b}, {tq}) / "
                             f"(B, Tk)=({b}, {tk})")
    elif kv_segment_ids is not None:
        raise ValueError("kv_segment_ids requires segment_ids")
    out, _lse = flash_fwd(q, k, v, q_seg, kv_seg, causal=causal,
                          scale=scale)
    return out
