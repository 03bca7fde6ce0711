"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_fwd.cu`` (B1) and ``csrc/flash_bwd.cu`` (B2 dQ, B3 dK/dV;
B2's ring modes in ``csrc/flash_dq_ring.cu``)
and their plain PyTorch versions (counterpart of
``mxnet_tpu/ops/flash.py``).

The public entry takes (B, T, H, D) and returns O in the same layout,
through :class:`_FlashAttention`, the autograd Function that stands for
the reference's ``_flash`` custom_vjp: its forward saves
(q, k, v, segment ids, lse) and its backward runs :func:`flash_bwd`
with B2 computing each row's delta from its own P and dP (the
reference takes rowsum(dO * O): equal in exact arithmetic).
:func:`flash_fwd` returns O and the per-row logsumexp, (B*H, 1, T)
float32 as the reference lays it out.  Each wrapper launches its kernel
for CUDA tensors (or raises) and takes the plain version for CPU
tensors, the analogue of Pallas interpret mode.

B1 is reached through one route, the ``torch.library`` custom op
``mxnet_tpu_torch::flash_fwd`` (``(q, k, v, q_seg?, kv_seg?, causal,
scale) -> (out, lse)``, registered once when this module is first
imported): :func:`flash_fwd` calls it, and so do ``_FlashAttention``
and every caller of :func:`flash_fwd`.  Its implementation launches B1
and counts the launch (or takes the plain version for CPU tensors); its
fake implementation gives the outputs' shapes, so ``torch.export`` of
a net whose attention takes the flash route traces the op as one node,
and the exported program launches B1 when it runs on the card.  The kernels read and
write the (B, T, H, D) layout in place through its strides, so no
transpose is made here.

Semantics shared by both versions: scores in float32; causal keeps keys
col <= row (tq == tk); packed segment ids mask keys of other segments;
the masked-safe exp zeroes masked entries; a row with no valid key gets
O = 0 and lse = -1e30 (and so zero dQ, and adds nothing to dK/dV); the
probabilities are rounded to the value dtype before the P.V product, as
the reference's ``p.astype(v.dtype)`` does.  The backward rounds as the
reference's does: P to dO's dtype before dV = P^T.dO, dS to k's dtype
before dQ = dS.K and to q's dtype before dK = dS^T.Q.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional

import torch

from ..base import MXNetError
from . import launches as _launches

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "flash_dq",
           "flash_dkv"]

_MASK = -1e30
_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _keep(q, k, q_seg, kv_seg, causal):
    """Which (query, key) pairs attend: (B or 1, 1, Tq, Tk) bool."""
    keep = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None]
    if q_seg is not None:
        keep = keep & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    return keep


def _fwd_plain(q, k, v, q_seg, kv_seg, causal, scale):
    """Masked softmax attention with the kernel's zero-row and lse rules:
    (O (B, T, H, D) in q's dtype, lse (B*H, 1, T) float32)."""
    b, tq, h, _d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(_keep(q, k, q_seg, kv_seg, causal), s,
                    torch.full_like(s, _MASK))
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
    return (out.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            lse.reshape(b * h, 1, tq))


def _own_delta(p, dp):
    """Each row's delta from the backward's own P and dP: sum_j P dP /
    sum_j P (0 for a row with no valid key), (B, H, Tq, 1) float32."""
    psum = p.sum(-1, keepdim=True)
    return torch.where(psum > 0, (p * dp).sum(-1, keepdim=True) /
                       torch.where(psum > 0, psum, torch.ones_like(psum)),
                       torch.zeros_like(psum))


def _p_dp(q, k, v, do, lse, q_seg, kv_seg, causal, scale):
    """P and dP (B, H, Tq, Tk) float32, P recomputed from lse as the
    kernels do (masked pairs give P = 0)."""
    b, tq, h, _d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(_keep(q, k, q_seg, kv_seg, causal), s,
                    torch.full_like(s, _MASK))
    p = torch.where(s <= _MASK * 0.5, torch.zeros_like(s),
                    torch.exp(s - lse.reshape(b, h, tq, 1)))
    return p, torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())


def _bwd_tiles(q, k, v, do, lse, delta, q_seg, kv_seg, causal, scale):
    """P, dS (B, H, Tq, Tk) float32 and delta (B, H, Tq, 1); ``delta``
    None (B2's own mode) is computed from P and dP
    (:func:`_own_delta`), else it is given, (B*H, 1, Tq) (B3, and B2's
    given mode)."""
    b, tq, h, _d = q.shape
    p, dp = _p_dp(q, k, v, do, lse, q_seg, kv_seg, causal, scale)
    delta = _own_delta(p, dp) if delta is None else \
        delta.reshape(b, h, tq, 1)
    return p, p * (dp - delta) * scale, delta


def _dq_plain(q, k, v, do, lse, q_seg, kv_seg, causal, scale,
              delta=None):
    """B2's plain version: (dQ (B, T, H, D) in q's dtype, delta (B*H, 1,
    T) float32) with delta computed as B2 computes it, or the given
    ``delta`` (B2's given mode)."""
    _p, ds, delta = _bwd_tiles(q, k, v, do, lse, delta, q_seg, kv_seg,
                               causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()).to(q.dtype)
    b, t, h, _d = q.shape
    return dq, delta.reshape(b * h, 1, t).contiguous()


def _dq_partial_plain(q, k, v, do, lse, q_seg, kv_seg, causal, scale):
    """B2's partial mode, plain: (sum_j P dP, sum_j P), each (B*H, 1, T)
    float32, over these keys."""
    p, dp = _p_dp(q, k, v, do, lse, q_seg, kv_seg, causal, scale)
    b, t, h, _d = q.shape
    return ((p * dp).sum(-1).reshape(b * h, 1, t).contiguous(),
            p.sum(-1).reshape(b * h, 1, t).contiguous())


def _dkv_plain(q, k, v, do, lse, delta, q_seg, kv_seg, causal, scale):
    """B3's plain version: (dK, dV) (B, T, H, D) in k's / v's dtype."""
    p, ds, _delta = _bwd_tiles(q, k, v, do, lse, delta, q_seg, kv_seg,
                               causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_plain(q, k, v, do, lse, q_seg, kv_seg, causal, scale):
    """(dQ, dK, dV) with the kernels' masks, casts and empty-row rule,
    delta as :func:`flash_bwd` takes it."""
    dq, delta = _dq_plain(q, k, v, do, lse, q_seg, kv_seg, causal, scale)
    return (dq, *_dkv_plain(q, k, v, do, lse, delta, q_seg, kv_seg, causal,
                            scale))


def _kernel_fn(lib, symbol, n_ptrs):
    """The C entry ``symbol`` of library ``lib``: ``n_ptrs`` pointers,
    then (batch, seq, heads, head_dim, causal), scale, dtype, stream."""
    from ..utils import native
    fn = getattr(native.load(lib), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptrs + [i] * 5 + [ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _check_cuda(name, q, k, v, q_seg, kv_seg, extra=()):
    """Raise on what the kernels do not take; ``extra`` are further
    (B, T, H, D) tensors (dO) that must match q."""
    for x in (k, v, *extra):
        if x.device != q.device:
            raise MXNetError(f"{name}: all inputs must share one device")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype
                                         for x in (k, v, *extra)):
        raise MXNetError(f"{name}: q, k, v must all be float32 or "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or any(x.shape != q.shape for x in (k, v, *extra)):
        raise MXNetError(f"{name}: q, k, v must be one (B, T, H, D) "
                         f"shape, got {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    if q.shape[3] not in _HEAD_DIMS:
        raise MXNetError(f"{name}: head dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in (q, k, v, *extra)):
        raise MXNetError(f"{name}: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v, *extra)):
        # the kernels copy rows in 16-byte pieces (cp.async), and TMA's
        # tensor maps (B1 in bf16) want 16-byte aligned bases
        raise MXNetError(f"{name}: inputs must be 16-byte aligned")
    if q.shape[0] * q.shape[2] > 65535:
        raise MXNetError(f"{name}: batch*heads exceeds the grid limit")
    for seg in (q_seg, kv_seg):
        if seg is not None and (seg.device != q.device
                                or seg.dtype != torch.int32
                                or tuple(seg.shape) != tuple(q.shape[:2])
                                or not seg.is_contiguous()):
            raise MXNetError(f"{name}: segment ids must be contiguous "
                             "(B, T) int32 on q's device")


def _check_rows(name, q, *rows):
    """lse / delta: contiguous (B*H, 1, T) float32 on q's device."""
    b, t, h, _d = q.shape
    for x in rows:
        if (x.device != q.device or x.dtype != torch.float32
                or tuple(x.shape) != (b * h, 1, t) or not x.is_contiguous()):
            raise MXNetError(f"{name}: lse and delta must be contiguous "
                             f"({b * h}, 1, {t}) float32 on q's device")


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _device_type(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"{name}: unsupported device {q.device}")
    return q.device.type


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, *, causal: bool,
              scale: float):
    """(O, lse) of self-attention over (B, T, H, D) inputs, through the
    custom op ``mxnet_tpu_torch::flash_fwd``: CUDA tensors launch
    ``csrc/flash_fwd.cu`` (counted by q's dtype in
    ``flash_fwd.launches_by_dtype``); CPU tensors take the plain
    version."""
    _device_type("flash_fwd", q)    # a meta tensor would get the fake
    return _FLASH_FWD_OP(q, k, v, q_seg, kv_seg, bool(causal), float(scale))


def _flash_fwd_impl(q, k, v, q_seg, kv_seg, causal, scale):
    """The op's implementation: B1 and its count for CUDA tensors, the
    plain version for CPU tensors."""
    if _device_type("flash_fwd", q) == "cpu":
        return _fwd_plain(q, k, v, q_seg, kv_seg, causal, scale)
    _check_cuda("flash_fwd", q, k, v, q_seg, kv_seg)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, 1, t), dtype=torch.float32, device=q.device)
    from ..utils.native import stream_ptr
    err = _kernel_fn("flash_fwd", "mxt_flash_fwd", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        out.data_ptr(), lse.data_ptr(), b, t, h, d, int(bool(causal)),
        float(scale), _DTYPE_CODE[q.dtype], stream_ptr(q.device))
    if err:
        raise MXNetError(f"flash_fwd: kernel launch failed (cudaError {err})")
    flash_fwd.launches_by_dtype[q.dtype] += 1
    return out, lse


_launches.register(flash_fwd,
                  launches_by_dtype=dict.fromkeys(_DTYPE_CODE, 0))


def _flash_fwd_op():
    """``torch.ops.mxnet_tpu_torch.flash_fwd.default``, defined on the
    first import: the schema, one implementation for every device
    (``CompositeExplicitAutograd``) and a fake one for tracing.  Not
    ``torch.library.custom_op``, whose kernel wrapper imports
    ``torch._dynamo`` at a process's first call (seconds on the card's
    host, in every rank and subprocess).  The registered functions look
    up this module's current ones, so a reload of the module reuses the
    registration and counts on the reloaded wrapper."""
    global _LIB
    try:
        return torch.ops.mxnet_tpu_torch.flash_fwd.default
    except AttributeError:
        pass

    def impl(q, k, v, q_seg, kv_seg, causal, scale):
        return sys.modules[__name__]._flash_fwd_impl(
            q, k, v, q_seg, kv_seg, causal, scale)

    def fake(q, k, v, q_seg, kv_seg, causal, scale):
        b, t, h, _d = q.shape
        return (q.new_empty(q.shape),
                q.new_empty((b * h, 1, t), dtype=torch.float32))

    # the registrations live as long as this object
    _LIB = torch.library.Library("mxnet_tpu_torch", "DEF")
    _LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? q_seg, "
                "Tensor? kv_seg, bool causal, float scale) -> "
                "(Tensor, Tensor)")
    _LIB.impl("flash_fwd", impl, "CompositeExplicitAutograd")
    torch.library.register_fake("mxnet_tpu_torch::flash_fwd", fake,
                                lib=_LIB)
    return torch.ops.mxnet_tpu_torch.flash_fwd.default


_FLASH_FWD_OP = _flash_fwd_op()


_DQ_MODES = {"own": 0, "partial": 1, "given": 2}


def flash_dq(q, k, v, do, lse, q_seg=None, kv_seg=None, *, causal: bool,
             scale: float, mode: str = "own", delta=None):
    """dQ of self-attention (B2).  ``lse`` is the forward's, (B*H, 1, T)
    float32.  ``mode``:

    - ``"own"`` (the single call) returns (dQ, delta): B2 computes each
      row's delta itself from its own P and dP (sum_j P dP / sum_j P, a
      first pass over the keys), which keeps each query's dS summing to
      0 (see ``csrc/flash_bwd.cu``), and returns it, (B*H, 1, T)
      float32, for B3;
    - ``"partial"`` returns (sum_j P dP, sum_j P), each (B*H, 1, T)
      float32, over these keys only, undivided, and no dQ: ring attention
      adds them over its key chunks (``ops/ring.py``);
    - ``"given"`` returns dQ computed with the given ``delta`` (B*H, 1,
      T) float32, skipping the first pass.

    CUDA tensors launch ``mxt_flash_dq`` of ``csrc/flash_bwd.cu`` (own)
    or ``mxt_flash_dq_mode`` of ``csrc/flash_dq_ring.cu`` (the ring modes;
    the same kernel, ``csrc/flash_bwd.cuh``), counted in
    ``flash_dq.launches_by_dtype``
    and ``flash_dq.launches_by_mode``; CPU tensors take the plain
    version."""
    if mode not in _DQ_MODES:
        raise MXNetError(f"flash_dq: mode {mode!r} not in "
                         f"{tuple(_DQ_MODES)}")
    if (delta is not None) != (mode == "given"):
        raise MXNetError("flash_dq: delta is given in the 'given' mode "
                         "and only there")
    if _device_type("flash_dq", q) == "cpu":
        if mode == "partial":
            return _dq_partial_plain(q, k, v, do, lse, q_seg, kv_seg,
                                     causal, scale)
        out = _dq_plain(q, k, v, do, lse, q_seg, kv_seg, causal, scale,
                        delta)
        return out[0] if mode == "given" else out
    _check_cuda("flash_dq", q, k, v, q_seg, kv_seg, (do,))
    _check_rows("flash_dq", q, lse, *(() if delta is None else (delta,)))
    b, t, h, d = q.shape
    rows = (b * h, 1, t)
    dq = None if mode == "partial" else torch.empty_like(q)
    delta_out = None if mode == "given" else \
        torch.empty(rows, dtype=torch.float32, device=q.device)
    psum = torch.empty(rows, dtype=torch.float32, device=q.device) \
        if mode == "partial" else None
    from ..utils.native import stream_ptr
    tail = (b, t, h, d, int(bool(causal)), float(scale),
            _DTYPE_CODE[q.dtype])
    if mode == "own":
        err = _kernel_fn("flash_bwd", "mxt_flash_dq", 9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta_out.data_ptr(), _ptr(q_seg),
            _ptr(kv_seg), dq.data_ptr(), *tail, stream_ptr(q.device))
    else:
        err = _dq_mode_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), _ptr(delta), _ptr(delta_out), _ptr(psum),
            _ptr(q_seg), _ptr(kv_seg), _ptr(dq), *tail, _DQ_MODES[mode],
            stream_ptr(q.device))
    if err:
        raise MXNetError(f"flash_dq: kernel launch failed (cudaError {err})")
    flash_dq.launches_by_dtype[q.dtype] += 1
    # by mode on the wrapper itself: a caller that stands another
    # function in for the module's name carries the dtype counter only
    _FLASH_DQ.launches_by_mode[mode] += 1
    if mode == "partial":
        return delta_out, psum
    return dq if mode == "given" else (dq, delta_out)


def _dq_mode_fn():
    """``mxt_flash_dq_mode``: 11 pointers, then (batch, seq, heads,
    head_dim, causal), scale, dtype, mode, stream."""
    from ..utils import native
    fn = native.load("flash_dq_ring").mxt_flash_dq_mode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 5 + [ctypes.c_float, i, i, p]
        fn.restype = i
    return fn


_FLASH_DQ = _launches.register(
    flash_dq, launches_by_dtype=dict.fromkeys(_DTYPE_CODE, 0),
    launches_by_mode=dict.fromkeys(_DQ_MODES, 0))


def flash_dkv(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
              causal: bool, scale: float):
    """(dK, dV) of self-attention (B3); ``delta`` is :func:`flash_dq`'s,
    the other arguments are as there.  CUDA tensors launch ``mxt_flash_dkv`` (counted in
    ``flash_dkv.launches_by_dtype``); CPU tensors take the plain
    version."""
    if _device_type("flash_dkv", q) == "cpu":
        return _dkv_plain(q, k, v, do, lse, delta, q_seg, kv_seg, causal,
                          scale)
    _check_cuda("flash_dkv", q, k, v, q_seg, kv_seg, (do,))
    _check_rows("flash_dkv", q, lse, delta)
    b, t, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    from ..utils.native import stream_ptr
    err = _kernel_fn("flash_bwd", "mxt_flash_dkv", 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        dk.data_ptr(), dv.data_ptr(), b, t, h, d, int(bool(causal)),
        float(scale), _DTYPE_CODE[q.dtype], stream_ptr(q.device))
    if err:
        raise MXNetError(f"flash_dkv: kernel launch failed (cudaError "
                         f"{err})")
    flash_dkv.launches_by_dtype[q.dtype] += 1
    return dk, dv


_launches.register(flash_dkv,
                  launches_by_dtype=dict.fromkeys(_DTYPE_CODE, 0))


def flash_bwd(q, k, v, do, lse, q_seg=None, kv_seg=None, *, causal: bool,
              scale: float):
    """(dQ, dK, dV): B2 then B3, fed B2's delta, for CUDA tensors; the
    plain version for CPU tensors."""
    if _device_type("flash_bwd", q) == "cpu":
        return _bwd_plain(q, k, v, do, lse, q_seg, kv_seg, causal, scale)
    kw = dict(causal=causal, scale=scale)
    dq, delta = flash_dq(q, k, v, do, lse, q_seg, kv_seg, **kw)
    return (dq, *flash_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, **kw))


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_flash``
    custom_vjp, ``flash.py:464-487``): B1 forward, B2 and B3 backward on
    the card; the plain versions on the CPU.  Segment ids get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        out, lse = flash_fwd(q, k, v, q_seg, kv_seg, causal=causal,
                             scale=scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, lse = ctx.saved_tensors
        # delta from B2's own P and dP (flash_dq), not rowsum(dO * O) as
        # the reference takes it (flash.py:386): the same in exact
        # arithmetic, and consistent with the products that use it
        dq, dk, dv = flash_bwd(q, k, v, do.contiguous(), lse, q_seg, kv_seg,
                               causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    segment_ids=None, kv_segment_ids=None):
    """Differentiable flash attention on (B, T, H, D) inputs →
    (B, T, H, D).

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
    return _FlashAttention.apply(q, k, v, q_seg, kv_seg, bool(causal),
                                 scale)
