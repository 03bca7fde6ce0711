"""The collectives of data- and sequence-parallel training: the port's
counterpart of what GSPMD and ``shard_map`` insert in the reference
(``psum`` of gradients, ``ppermute`` around the ring, ``all_to_all``),
as explicit ``torch.distributed`` calls over a mesh axis's group.

- :func:`all_reduce_` sums a list of tensors in place over a group, in
  flat buckets of at most ``bucket_bytes`` per dtype, as DDP does;
- :func:`ring_shift` sends tensors to the next rank of the ring and
  receives the previous rank's (``batch_isend_irecv``);
- :func:`all_to_all` splits a tensor along one dim over the group and
  concatenates what arrives along another; :func:`all_gather` and
  :func:`broadcast_` complete the set.

**The gloo transport.**  On a host with one GPU two ranks can only share
it over gloo (NCCL refuses two ranks on one device), and gloo moves host
memory.  So under gloo a CUDA tensor is copied into a pinned host buffer
on the current stream, the host waits on an event recorded after that
copy (not on the whole device), gloo moves the host buffer, and the
result is copied back on the current stream.  PyTorch's pinned-memory
cache keeps a host buffer alive until the copy out of it has run.  The
bytes staged each way are counted in :func:`stats`.  Only the transport
goes through the host: the compute never leaves the card.  Under NCCL
tensors move as they are, and a step that holds only NCCL collectives
(or none) can be captured into a CUDA graph.

A group of None is this rank alone: every call is then the identity.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_reduce_", "ring_shift", "exchange", "all_to_all",
           "all_gather", "broadcast_", "stats", "reset_stats", "staging",
           "BUCKET_BYTES"]

#: DDP's default bucket size
BUCKET_BYTES = 25 << 20

# the collectives of a group are issued from one thread (every rank must
# issue them in one order), so their counters need no lock
_STATS: Dict[str, float] = {}


def reset_stats():
    """Set the counters of :func:`stats` to 0."""
    _STATS.clear()


def stats() -> dict:
    """Counters since :func:`reset_stats`: calls by collective,
    ``staged_bytes_d2h`` / ``staged_bytes_h2d`` (gloo's host staging of
    CUDA tensors), ``staged_copies``, ``bytes`` (payload handed to a
    collective), ``all_reduce_seconds`` (the host's wall time inside
    :func:`all_reduce_`: under gloo the whole transfer, under NCCL the
    enqueue) and the backend."""
    out = dict(_STATS)
    out["backend"] = dist.get_backend() if dist.is_initialized() else None
    return out


def _count(key: str, n=1):
    _STATS[key] = _STATS.get(key, 0) + n


def staging(group=None) -> bool:
    """Whether CUDA tensors go through pinned host buffers in ``group``
    (gloo)."""
    return dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor ``x``, complete when this
    returns: the copy is ordered after ``x``'s producer on the current
    stream and the host waits on an event recorded after it."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    _count("staged_bytes_d2h", x.numel() * x.element_size())
    _count("staged_copies")
    return host


def _from_host(dst: torch.Tensor, host: torch.Tensor):
    dst.copy_(host, non_blocking=True)
    _count("staged_bytes_h2d", host.numel() * host.element_size())


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and staging(group)


def _flat_buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    """Lists of indices into ``tensors``, one dtype and at most
    ``bucket_bytes`` (or one tensor) each, in order."""
    buckets: List[List[int]] = []
    open_: Dict[torch.dtype, List[int]] = {}
    size: Dict[torch.dtype, int] = {}
    for i, t in enumerate(tensors):
        nb = t.numel() * t.element_size()
        b = open_.get(t.dtype)
        if b is not None and size[t.dtype] + nb > bucket_bytes:
            buckets.append(b)
            b = None
        if b is None:
            b = open_[t.dtype] = []
            size[t.dtype] = 0
        b.append(i)
        size[t.dtype] += nb
    buckets.extend(open_.values())
    return buckets


def all_reduce_(tensors: Sequence[torch.Tensor], group=None,
                bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum each tensor over ``group`` in place, through flat buckets."""
    if group is None or not tensors:
        return
    t0 = time.perf_counter()
    for idx in _flat_buckets(tensors, bucket_bytes):
        parts = [tensors[i] for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts]) if len(parts) > 1 \
            else parts[0].reshape(-1).clone()
        _count("all_reduce")
        _count("bytes", flat.numel() * flat.element_size())
        if _staged(flat, group):
            host = _to_host(flat)
            dist.all_reduce(host, group=group)
            _from_host(flat, host)
        else:
            dist.all_reduce(flat, group=group)
        off = 0
        for p in parts:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n
    _count("all_reduce_seconds", time.perf_counter() - t0)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None,
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Overwrite each tensor with global rank ``src``'s, in place."""
    if group is None or not tensors:
        return
    for idx in _flat_buckets(tensors, bucket_bytes):
        parts = [tensors[i] for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts])
        _count("broadcast")
        _count("bytes", flat.numel() * flat.element_size())
        if _staged(flat, group):
            host = _to_host(flat)
            dist.broadcast(host, src, group=group)
            _from_host(flat, host)
        else:
            dist.broadcast(flat, src, group=group)
        off = 0
        for p in parts:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n


def ring_shift(tensors: Sequence[torch.Tensor], group,
               shift: int = 1) -> List[torch.Tensor]:
    """Send each tensor to the rank ``shift`` places on around the ring
    of ``group`` and return what arrives from ``shift`` places back (the
    reference's ``ppermute`` with ``(i, i + shift)`` pairs).  New
    tensors; the inputs are not written."""
    if group is None:
        return [t.clone() for t in tensors]
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    _count("ring_shift")
    return exchange([(t, (me + shift) % n) for t in tensors],
                    [(t, (me - shift) % n) for t in tensors], group)


def exchange(sends, recvs, group) -> List[torch.Tensor]:
    """Point-to-point moves inside ``group`` in one batch: ``sends`` are
    (tensor, destination's rank in the group), ``recvs`` (a tensor of
    the shape and dtype that arrives, source's rank in the group).
    Returns the received tensors, on the templates' device."""
    staged = any(_staged(t, group) for t, _ in list(sends) + list(recvs))
    ops, outs = [], []
    for t, dst in sends:
        t = _to_host(t.contiguous()) if staged else t.contiguous()
        _count("bytes", t.numel() * t.element_size())
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst),
                              group))
    for like, src in recvs:
        r = torch.empty(like.shape, dtype=like.dtype,
                        device="cpu" if staged else like.device,
                        pin_memory=staged)
        outs.append(r)
        ops.append(dist.P2POp(dist.irecv, r,
                              dist.get_global_rank(group, src), group))
    _count("exchange")
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if not staged:
        return outs
    devs = []
    for (like, _src), r in zip(recvs, outs):
        d = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        _from_host(d, r)
        devs.append(d)
    return devs


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``x`` into |group| pieces along ``split_dim``, send piece j
    to the group's rank j, and concatenate the pieces that arrive along
    ``concat_dim`` in rank order (the reference's tiled
    ``lax.all_to_all``)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    pieces = [p.contiguous() for p in torch.chunk(x, n, dim=split_dim)]
    send = torch.stack(pieces)                      # (n, *piece)
    staged = _staged(send, group)
    if staged:
        send = _to_host(send)
    recv = torch.empty_like(send)
    _count("all_to_all")
    _count("bytes", send.numel() * send.element_size())
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        dev = torch.empty(recv.shape, dtype=recv.dtype, device=x.device)
        _from_host(dev, recv)
        recv = dev
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` in the group's rank order."""
    if group is None:
        return [x]
    n = dist.get_world_size(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _to_host(src)
    outs = [torch.empty_like(src) for _ in range(n)]
    _count("all_gather")
    _count("bytes", src.numel() * src.element_size())
    dist.all_gather(outs, src, group=group)
    if staged:
        devs = []
        for o in outs:
            d = torch.empty(o.shape, dtype=o.dtype, device=x.device)
            _from_host(d, o)
            devs.append(d)
        outs = devs
    return outs
