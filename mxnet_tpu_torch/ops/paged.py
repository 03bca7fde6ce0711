"""Paged attention: the CUDA kernel ``csrc/paged_attention.cu`` and its
plain PyTorch version, plus the int8 KV quantizer (counterpart of
``mxnet_tpu/ops/paged.py``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, the analogue of Pallas interpret mode.  The plain
version gathers each slot's pages into a dense row and runs the same
masked softmax: keys k <= qpos, the masked-safe exp, zeros for a row
with no key, int8 pages dequantized by their scales.  The kernel walks
each slot's table in splits of :func:`split_count` runs of pages and
merges their partial softmaxes in a second pass (``csrc/
paged_attention.cu``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..base import torch_dtype

from ..base import MXNetError
from . import launches as _launches

__all__ = ["paged_attention", "kv_quantize", "kv_dequantize", "split_count",
           "KERNEL_HEAD_DIMS"]

_MASK = -1e30
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: the head dims the CUDA kernel is built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
#: about how many keys one split of the kernel's page walk covers
SPLIT_KEYS = 64


# ------------------------------------------------------------ quantization

def kv_quantize(x, scale_dtype=torch.float32):
    """Symmetric per-position-per-head int8 quantization over the last
    (head_dim) axis: ``scale = max(|x|) / 127``, ``q = round(x / scale)``.
    Returns ``(int8 values, scale)`` with the scale (``scale_dtype``)
    shaped like ``x`` but with a trailing dim of 1.  The 1e-8 floor keeps
    an all-zero input (padding, the zero page) exact: q = 0 dequantizes
    to 0.0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return q.to(torch.int8), scale.to(torch_dtype(scale_dtype))


def kv_dequantize(q, scale):
    """Inverse of :func:`kv_quantize`: ``q * scale`` in float32."""
    return q.float() * scale.float()


# ------------------------------------------------------------------ kernel

def _paged_plain(q, k_pages, v_pages, table_rows, qpos, k_scale, v_scale,
                 scale):
    b, tq, h, d = q.shape
    p = table_rows.shape[1]
    ps = k_pages.shape[1]
    idx = table_rows.long()
    kf = k_pages[idx].float().reshape(b, p * ps, h, d)
    vf = v_pages[idx].float().reshape(b, p * ps, h, d)
    if k_scale is not None:
        kf = kf * k_scale[idx].float().reshape(b, p * ps, h, 1)
        vf = vf * v_scale[idx].float().reshape(b, p * ps, h, 1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    keys = torch.arange(p * ps, device=q.device)
    keep = keys[None, None, None, :] <= qpos.long()[:, None, :, None]
    s = torch.where(keep, s, torch.full_like(s, _MASK))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(s <= _MASK * 0.5, torch.zeros_like(s), torch.exp(s - m))
    l = e.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", e, vf)
    out = torch.where(l <= 0.0, torch.zeros_like(pv),
                      pv / torch.where(l <= 0.0, torch.ones_like(l), l))
    return out.permute(0, 2, 1, 3).to(q.dtype)


def split_count(page_size: int, pages_per_row: int) -> int:
    """How many splits the kernel cuts a slot's table of
    ``pages_per_row`` pages into: runs of ``SPLIT_KEYS // page_size``
    pages (at least one), so a split covers about ``SPLIT_KEYS`` keys.
    Split ``c`` takes pages ``[c * r, (c + 1) * r)`` with
    ``r = ceil(pages_per_row / count)``."""
    per = max(1, SPLIT_KEYS // page_size)
    return -(-pages_per_row // per)


def _kernel_fn():
    from ..utils import native
    fn = native.load("paged_attention").mxt_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 9 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def _check_cuda(q, k_pages, v_pages, table_rows, qpos, k_scale, v_scale):
    dev = q.device
    tensors = [k_pages, v_pages, table_rows, qpos] + \
        [t for t in (k_scale, v_scale) if t is not None]
    if any(t.device != dev for t in tensors):
        raise MXNetError("paged_attention: all inputs must share q's device")
    if q.dim() != 4 or q.dtype not in _Q_CODE:
        raise MXNetError(f"paged_attention: q must be (B, Tq, H, D) float32 "
                         f"or bfloat16, got {tuple(q.shape)} {q.dtype}")
    b, tq, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise MXNetError(f"paged_attention: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or \
            tuple(k_pages.shape[2:]) != (h, d):
        raise MXNetError(f"paged_attention: pages must be (N, ps, {h}, {d}), "
                         f"got {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in (
            q.dtype, torch.int8):
        raise MXNetError(f"paged_attention: pages must have q's dtype or be "
                         f"int8, got {k_pages.dtype}/{v_pages.dtype}")
    if k_pages.dtype == torch.int8:
        want = tuple(k_pages.shape[:3]) + (1,)
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != want \
                    or not sc.is_contiguous():
                raise MXNetError(f"paged_attention: scales must be "
                                 f"contiguous {want} float32")
    if table_rows.dtype != torch.int32 or table_rows.dim() != 2 or \
            table_rows.shape[0] != b:
        raise MXNetError(f"paged_attention: table must be ({b}, P) int32")
    if qpos.dtype != torch.int32 or tuple(qpos.shape) != (b, tq):
        raise MXNetError(f"paged_attention: qpos must be ({b}, {tq}) int32")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, table_rows,
                                           qpos)):
        raise MXNetError("paged_attention: inputs must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        # the kernel copies page rows in 16-byte pieces (cp.async)
        raise MXNetError("paged_attention: pages must be 16-byte aligned")
    if b * -(-tq // 4) > 65535 or h > 65535:
        raise MXNetError("paged_attention: batch/heads exceed the grid limit")


def paged_attention(q, k_pages, v_pages, table_rows, qpos, *,
                    k_scale=None, v_scale=None,
                    scale: Optional[float] = None):
    """Attention over paged K/V, read in place through the page table.

    q ``(B, Tq, H, D)``; pages ``(N, ps, H, D)`` float or int8 (then
    ``k_scale``/``v_scale`` ``(N, ps, H, 1)`` float32 are required);
    ``table_rows`` ``(B, P)`` int32; ``qpos`` ``(B, Tq)`` int32 absolute
    query positions — key ``k`` is attended iff ``k <= qpos``.  Returns
    ``(B, Tq, H, D)`` in q's dtype.  CUDA tensors launch
    ``csrc/paged_attention.cu`` (counted in ``paged_attention.launches``);
    CPU tensors take the plain version."""
    b, tq, h, d = q.shape
    quant = k_pages.dtype == torch.int8
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("int8 pages require k_scale/v_scale")
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if not quant:
        k_scale = v_scale = None
    if q.device.type == "cpu":
        return _paged_plain(q, k_pages, v_pages, table_rows, qpos, k_scale,
                            v_scale, scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_attention: unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, table_rows, qpos, k_scale, v_scale)
    ps, npt = k_pages.shape[1], table_rows.shape[1]
    ns = split_count(ps, npt)
    out = torch.empty_like(q)
    # each split's partial (acc[D], then m and l) for every row
    scratch = torch.empty(b * tq * h * ns * (d + 2), dtype=torch.float32,
                          device=q.device)
    from ..utils.native import stream_ptr
    err = _kernel_fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        table_rows.data_ptr(), qpos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, tq, h, d, ps, npt, ns,
        _Q_CODE[q.dtype], _PAGE_CODE[k_pages.dtype], scale,
        stream_ptr(q.device))
    if err:
        raise MXNetError(f"paged_attention: kernel launch failed "
                         f"(cudaError {err})")
    paged_attention.launches += 1
    if tq > 1:
        paged_attention.multi_query_launches += 1
    return out


_launches.register(paged_attention, launches=0, multi_query_launches=0)
