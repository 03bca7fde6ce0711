"""Ring attention: sequence parallelism over the ``sp`` mesh axis
(counterpart of ``mxnet_tpu/ops/ring.py``).

Each rank passes, and gets back, its own natural-order chunk of the
sequence, (B/dp, T/sp, H, D): rank r of the ``sp`` group holds positions
``[r * T/sp, (r + 1) * T/sp)``.  That is a divergence by design from the
reference, whose ``ring_attention`` takes global arrays and shards them
with ``shard_map``; under SPMD in each process the local chunk is what a
rank has.  Q stays put; K and V (and their segment ids) travel around the
ring (:func:`~mxnet_tpu_torch.parallel.collectives.ring_shift`, the
reference's ``ppermute``).

**Forward.**  Each (local query block, visiting key block) pair runs B1
(``flash_fwd``): causal where the two blocks are the same positions (the
diagonal), full where every key precedes every query, and skipped where
every key follows every query.  The blocks' outputs merge by their
logsumexp (the reference's ``_merge``, in float32; plain torch, as the
reference's merge is not Pallas either).

**Backward** (:class:`_RingAttention`, the reference's
``jax.checkpoint``-ed blocks under autodiff): with the global lse saved
by the forward, every live block runs B2 twice and B3 once.  One round
of the ring sums each row's sum_j P dP and sum_j P over every key block
(B2's ``partial`` mode), so delta = their ratio is B2's own-delta rule
over the whole sequence; a second round runs B2 in its ``given`` mode
(dQ) and B3 (dK, dV) with that delta, while the dK and dV sums ride the
ring with their K/V block, and one more shift hands them to their owner.

**Balanced (zigzag) layout**, the default for causal attention when the
local chunk has an even length: the op exchanges halves so that rank r
computes on chunks r and 2*sp-1-r of a 2*sp-way split (equal work per
rank), and exchanges them back, so callers keep natural order.
``segment_ids`` (B/dp, T/sp), this rank's ids, reach the kernels' qseg /
kseg and travel with their K/V block.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..parallel import collectives as _coll
from ..parallel.mesh import axis_size, current_mesh
from .attention import dot_product_attention
from .flash import flash_dkv, flash_dq, flash_fwd

__all__ = ["ring_attention", "nd_ring_attention"]


def _pieces(pos: int, n: int, tl: int, balanced: bool):
    """The (start position, length) of each block rank ``pos`` of ``n``
    computes on, in the layout's order."""
    if not balanced:
        return [(pos * tl, tl)]
    hl = tl // 2
    return [(pos * hl, hl), ((2 * n - 1 - pos) * hl, hl)]


def _kind(qp, kp, causal) -> Optional[bool]:
    """For query block ``qp`` against key block ``kp``: None (every key
    follows every query: skipped), True (the same positions: causal) or
    False (full)."""
    if not causal:
        return False
    if kp[0] == qp[0]:
        return True
    return False if kp[0] < qp[0] else None


def _split(x, lengths):
    """``x`` cut along T (dim 1) into contiguous blocks."""
    out, o = [], 0
    for n in lengths:
        out.append(x[:, o:o + n].contiguous())
        o += n
    return out


def _zigzag(x, pos, n, group, inverse=False):
    """Natural-order chunk ``x`` (B, 2h, ...) of rank ``pos`` as its two
    zigzag halves, or (``inverse``) the zigzag halves back as its natural
    chunk.  Half-chunk c of a 2n split sits at natural rank c // 2, slot
    c % 2, and at zigzag rank min(c, 2n-1-c), slot c >= n."""
    def natural(c):
        return c // 2, c % 2

    def zig(c):
        return (c, 0) if c < n else (2 * n - 1 - c, 1)

    src_of, dst_of = (zig, natural) if inverse else (natural, zig)
    mine = [c for c in range(2 * n) if src_of(c)[0] == pos]
    wanted = [c for c in range(2 * n) if dst_of(c)[0] == pos]
    halves = list(x) if inverse else _split(x, [x.shape[1] // 2] * 2)
    have = {c: halves[src_of(c)[1]] for c in mine}
    sends = [(have[c], dst_of(c)[0]) for c in mine if dst_of(c)[0] != pos]
    recv_cs = [c for c in wanted if c not in have]
    like = halves[0]
    got = _coll.exchange(sends, [(like, src_of(c)[0]) for c in recv_cs],
                         group) if (sends or recv_cs) else []
    have.update(zip(recv_cs, got))
    out = [None, None]
    for c in wanted:
        out[dst_of(c)[1]] = have[c]
    return torch.cat(out, dim=1) if inverse else out


def _rows(lse, b, h):
    """(B*H, 1, T) row values as (B, T, H, 1)."""
    return lse.reshape(b, h, -1).permute(0, 2, 1)[..., None]


def _merge(o, lse, o_c, lse_c, b, h):
    """Online-softmax combination of two normalized partial results
    (O float32 (B, T, H, D), lse (B*H, 1, T))."""
    new = torch.logaddexp(lse, lse_c)
    w_old = _rows(torch.exp(lse - new), b, h)
    w_new = _rows(torch.exp(lse_c - new), b, h)
    return o * w_old + o_c.float() * w_new, new


class _RingAttention(torch.autograd.Function):
    """Differentiable ring attention over one ``sp`` group; see the
    module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group, pos, n, causal, scale, balanced):
        tl = q.shape[1]
        mine = _pieces(pos, n, tl, balanced)
        if balanced:
            qs, ks, vs = (_zigzag(x, pos, n, group) for x in (q, k, v))
            segs = _zigzag(seg, pos, n, group) if seg is not None else None
        else:
            qs, ks, vs = [q.contiguous()], [k.contiguous()], [v.contiguous()]
            segs = [seg] if seg is not None else None
        outs, lses = _ring_forward(qs, ks, vs, segs, group, pos, n, mine,
                                   causal, scale, balanced, tl)
        ctx.save_for_backward(*qs, *ks, *vs, *lses, *(segs or ()))
        ctx.meta = (group, pos, n, causal, scale, balanced, tl, len(qs),
                    segs is not None)
        outs = [o.to(q.dtype).contiguous() for o in outs]
        if balanced:
            return _zigzag(outs, pos, n, group, inverse=True)
        return outs[0]

    @staticmethod
    def backward(ctx, do):
        group, pos, n, causal, scale, balanced, tl, m, has_seg = ctx.meta
        saved = list(ctx.saved_tensors)
        qs, ks, vs, lses = (saved[i * m:(i + 1) * m] for i in range(4))
        segs = saved[4 * m:] if has_seg else None
        do = do.contiguous()
        dos = _zigzag(do, pos, n, group) if balanced else [do]
        dqs, dks, dvs = _ring_backward(qs, ks, vs, dos, lses, segs, group,
                                       pos, n, causal, scale, balanced, tl)
        if balanced:
            dq, dk, dv = (_zigzag(x, pos, n, group, inverse=True)
                          for x in (dqs, dks, dvs))
        else:
            dq, dk, dv = dqs[0], dks[0], dvs[0]
        return dq, dk, dv, None, None, None, None, None, None, None


def _visits(group, n, ks, vs, segs, extra=()):
    """Yield (step t, K blocks, V blocks, seg blocks or None, extra)
    around the ring: step t holds the blocks of rank pos - t, each step
    after the first receiving them, with the ``extra`` tensors that ride
    along, from the previous rank.  A value sent into the generator
    replaces the extra tensors before the next shift."""
    blocks = list(ks) + list(vs) + list(segs or ()) + list(extra)
    m = len(ks)
    for t in range(n):
        if t:
            blocks = _coll.ring_shift(blocks, group)
        kb, vb = blocks[:m], blocks[m:2 * m]
        rest = blocks[2 * m:]
        sb = rest[:m] if segs is not None else None
        ex = rest[m:] if segs is not None else rest
        new_extra = yield t, kb, vb, sb, ex
        if new_extra is not None:
            blocks = blocks[:len(blocks) - len(new_extra)] + list(new_extra)


def _ring_forward(qs, ks, vs, segs, group, pos, n, mine, causal, scale,
                  balanced, tl):
    b, h = qs[0].shape[0], qs[0].shape[2]
    outs: List[Optional[torch.Tensor]] = [None] * len(qs)
    lses: List[Optional[torch.Tensor]] = [None] * len(qs)
    for t, kb, vb, sb, _ex in _visits(group, n, ks, vs, segs):
        theirs = _pieces((pos - t) % n, n, tl, balanced)
        for i, qp in enumerate(mine):
            for j, kp in enumerate(theirs):
                kind = _kind(qp, kp, causal)
                if kind is None:
                    continue
                o, lse = flash_fwd(qs[i], kb[j], vb[j],
                                   segs[i] if segs else None,
                                   sb[j] if sb else None,
                                   causal=kind, scale=scale)
                if outs[i] is None:
                    outs[i], lses[i] = o.float(), lse
                else:
                    outs[i], lses[i] = _merge(outs[i], lses[i], o, lse, b, h)
    return outs, [x.contiguous() for x in lses]


def _ring_backward(qs, ks, vs, dos, lses, segs, group, pos, n, causal,
                   scale, balanced, tl):
    mine = _pieces(pos, n, tl, balanced)

    def live(t):
        theirs = _pieces((pos - t) % n, n, tl, balanced)
        for i, qp in enumerate(mine):
            for j, kp in enumerate(theirs):
                kind = _kind(qp, kp, causal)
                if kind is not None:
                    yield i, j, kind

    def args(i, j, kb, vb, sb):
        return (qs[i], kb[j], vb[j], dos[i], lses[i],
                segs[i] if segs else None, sb[j] if sb else None)

    # round 1: each row's sum_j P dP and sum_j P over every key block
    pdp = [torch.zeros_like(x) for x in lses]
    psum = [torch.zeros_like(x) for x in lses]
    for t, kb, vb, sb, _ex in _visits(group, n, ks, vs, segs):
        for i, j, kind in live(t):
            a, s = flash_dq(*args(i, j, kb, vb, sb), causal=kind,
                            scale=scale, mode="partial")
            pdp[i] += a
            psum[i] += s
    delta = [torch.where(s > 0, a / torch.where(s > 0, s, torch.ones_like(s)),
                         torch.zeros_like(s)).contiguous()
             for a, s in zip(pdp, psum)]

    # round 2: dQ here; dK and dV summed as they ride with their block
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in list(ks) + list(vs)]
    m = len(ks)
    walk = _visits(group, n, ks, vs, segs, acc)
    step = next(walk)
    while True:
        t, kb, vb, sb, ex = step
        ex = list(ex)
        for i, j, kind in live(t):
            a = args(i, j, kb, vb, sb)
            dqs[i] += flash_dq(*a, causal=kind, scale=scale, mode="given",
                               delta=delta[i]).float()
            dk, dv = flash_dkv(*a[:5], delta[i], *a[5:], causal=kind,
                               scale=scale)
            ex[j] = ex[j] + dk.float()
            ex[m + j] = ex[m + j] + dv.float()
        try:
            step = walk.send(ex)
        except StopIteration:
            break
    # the sums now sit one rank behind their owner's
    ex = _coll.ring_shift(ex, group)
    dks = [x.to(k.dtype) for x, k in zip(ex[:m], ks)]
    dvs = [x.to(v.dtype) for x, v in zip(ex[m:], vs)]
    return [x.to(q.dtype) for x, q in zip(dqs, qs)], dks, dvs


def ring_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None, mesh=None,
                   axis: str = "sp", batch_axis: str = "dp",
                   heads_axis: str = "tp", balance: Optional[bool] = None,
                   segment_ids=None):
    """Sequence-parallel attention on this rank's (B/dp, T/sp, H, D)
    chunks of q, k and v (natural order), returning this rank's chunk of
    the output.  With the ``axis`` of size 1 (or no mesh) it is
    :func:`~mxnet_tpu_torch.ops.attention.dot_product_attention` on the
    whole sequence.  Every block runs the flash kernels (their plain
    versions on the CPU).

    ``balance`` (default: on for causal when the local chunk's length is
    even) computes on the zigzag layout; ``segment_ids`` (B/dp, T/sp)
    int are this rank's packed segment ids (tokens attend only within
    their own segment)."""
    mesh = mesh or current_mesh()
    steps = axis_size(mesh, axis) if mesh is not None else 1
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    seg = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device).to(
            torch.int32).contiguous()
        if tuple(seg.shape) != (q.shape[0], q.shape[1]):
            raise ValueError(
                f"segment_ids must be (B, T)={(q.shape[0], q.shape[1])}, "
                f"got {tuple(seg.shape)}")
    if steps == 1:
        return dot_product_attention(q, k, v, causal=causal, scale=scale,
                                     segment_ids=seg)
    t = q.shape[1]
    if k.shape[1] != t:
        raise ValueError(
            f"ring attention needs tq == tk divisible by |{axis}|={steps}, "
            f"got tq={t * steps}, tk={k.shape[1] * steps}")
    if balance and not causal:
        raise ValueError("balance=True requires causal=True (the zigzag "
                         "layout only pays off under causal masking)")
    if balance is None:
        balance = causal and t % 2 == 0
    if causal and balance and t % 2:
        raise ValueError(
            f"balanced causal ring needs T divisible by "
            f"2*|{axis}|={2 * steps}, got {t * steps}")
    return _RingAttention.apply(q, k, v, seg, mesh.group(axis),
                                mesh.axis_index(axis), steps, bool(causal),
                                scale, bool(causal and balance))


def nd_ring_attention(query, key, value, *, causal=False, scale=None,
                      mesh=None, axis="sp", balance=None, segment_ids=None):
    """NDArray-level entry (autograd-recorded) for ring attention.
    ``segment_ids`` (B, T) is a non-differentiable side input."""
    from ..ndarray.ops import _as_nd, invoke
    query, key, value = _as_nd(query), _as_nd(key), _as_nd(value)
    seg = segment_ids.tensor if hasattr(segment_ids, "tensor") \
        else segment_ids

    def f(q, k, v):
        return ring_attention(q, k, v, causal=causal, scale=scale,
                              mesh=mesh, axis=axis, balance=balance,
                              segment_ids=seg)

    return invoke("ring_attention", f, [query, key, value])
