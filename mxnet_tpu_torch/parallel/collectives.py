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
  :func:`broadcast_` complete the set;
- the autograd functions of tensor, expert and pipeline parallelism
  (Megatron-LM's pair): :func:`copy_to` (identity forward, sum over the
  group backward) before a layer whose ranks each hold a block of its
  weights, :func:`reduce_from` (sum forward, identity backward) after
  it; :func:`psum` (sum both ways: the reference's ``psum`` and its
  transpose), :func:`all_reduce` with a max for the vocab-parallel
  loss's row maxima, :func:`gather_cat`, the blocks of a group joined
  along one dim (the keys of attention under ``sp``, a vocabulary block
  of the logits), :func:`pipe_shift`, the pipeline's send to the
  next stage and receive from the previous, whose backward sends the
  gradient back, and :func:`from_owner`, the pipeline's output handed
  from the last stage to every stage, whose gradient returns to the
  last stage alone.

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
           "tag_group", "BUCKET_BYTES", "all_reduce", "copy_to",
           "reduce_from", "psum", "pipe_shift", "from_owner", "gather_cat"]

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


# the mesh axes each group spans, by the group's id (Mesh._make_groups)
_TAGS: Dict[int, str] = {}


def tag_group(group, axes) -> None:
    """Record that ``group`` spans mesh ``axes`` (for :func:`stats`)."""
    _TAGS[id(group)] = "+".join(axes)


class _timed:
    """Adds the wall time of its body and ``nbytes`` to the counters of
    ``group``'s axes."""

    def __init__(self, group, nbytes):
        self.tag = _TAGS.get(id(group), "other")
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *a):
        _count(f"seconds:{self.tag}", time.perf_counter() - self.t0)
        _count(f"bytes:{self.tag}", self.nbytes)


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
    with _timed(group, sum(t.numel() * t.element_size() for t in tensors)):
        _all_reduce_buckets(tensors, group, bucket_bytes)
    _count("all_reduce_seconds", time.perf_counter() - t0)


def _all_reduce_buckets(tensors, group, bucket_bytes):
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
        with _timed(group, flat.numel() * flat.element_size()):
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
        with _timed(group, sum(op.tensor.numel() * op.tensor.element_size()
                               for op in ops)):
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
    with _timed(group, send.numel() * send.element_size()):
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
    with _timed(group, src.numel() * src.element_size()):
        dist.all_gather(outs, src, group=group)
    if staged:
        devs = []
        for o in outs:
            d = torch.empty(o.shape, dtype=o.dtype, device=x.device)
            _from_host(d, o)
            devs.append(d)
        outs = devs
    return outs


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (``op`` 'sum' or 'max'), a new
    tensor; not differentiable."""
    if group is None:
        return x.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    flat = x.detach().contiguous().clone()
    nbytes = flat.numel() * flat.element_size()
    _count("all_reduce")
    _count("bytes", nbytes)
    with _timed(group, nbytes):
        if _staged(flat, group):
            host = _to_host(flat)
            dist.all_reduce(host, op=red, group=group)
            _from_host(flat, host)
        else:
            dist.all_reduce(flat, op=red, group=group)
    return flat


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a model-parallel region: ``x`` as it is, whose gradient is
    summed over ``group`` (each rank's block of the next layer gives a
    part of it)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a model-parallel region: the sum over ``group`` of each
    rank's partial ``x``; the gradient passes as it is (every rank goes on
    with the same sum)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, whose backward sums the
    cotangents too (the reference's ``psum`` and its transpose)."""
    return x if group is None else _Psum.apply(x, group)


def _shift(x, group, me, n, step):
    """Send ``x`` to the group rank ``me + step`` (if any) and return what
    the group rank ``me - step`` sent (zeros if none)."""
    sends = [(x, me + step)] if 0 <= me + step < n else []
    recvs = [(x, me - step)] if 0 <= me - step < n else []
    got = exchange(sends, recvs, group)
    return got[0] if got else torch.zeros_like(x)


class _PipeShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, n):
        ctx.meta = (group, me, n)
        _count("pipe_shift")
        return _shift(x.detach(), group, me, n, 1)

    @staticmethod
    def backward(ctx, g):
        group, me, n = ctx.meta
        return _shift(g.contiguous(), group, me, n, -1), None, None, None


def pipe_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The pipeline's hand-over along ``group`` (the ``pp`` line): each
    rank sends ``x`` to the next rank of the group and returns what the
    previous one sent (zeros on the first); the last sends nothing.  The
    backward sends each gradient back the other way (the reference's
    ``ppermute`` over ``(i, i + 1)`` and its transpose).  Every rank of
    the group calls it together."""
    if group is None:
        return torch.zeros_like(x)
    return _PipeShift.apply(x, group, dist.get_rank(group),
                            dist.get_world_size(group))


class _FromOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mine):
        ctx.mine = mine
        return all_reduce(x if mine else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def from_owner(x: torch.Tensor, group, mine: bool) -> torch.Tensor:
    """The ``x`` of the one rank of ``group`` where ``mine`` is True, on
    every rank of the group (a sum of the owner's ``x`` and zeros).  The
    gradient goes back to the owner only, as its own cotangent: every
    rank computes the same thing from the value, and it counts once
    (``ShardedTrainer`` takes the loss's gradient on the last pipeline
    stage)."""
    if group is None:
        return x
    return _FromOwner.apply(x, group, bool(mine))


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.meta = (group, dim, grad)
        return torch.cat(all_gather(x.detach(), group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, grad = ctx.meta
        n = dist.get_world_size(group)
        size = g.shape[dim] // n
        if grad == "sum":
            g = all_reduce(g.contiguous(), group)
        return g.narrow(dim, dist.get_rank(group) * size, size), None, \
            None, None


def gather_cat(x: torch.Tensor, group, dim: int,
               grad: str = "sum") -> torch.Tensor:
    """Every rank's ``x`` of ``group`` joined along ``dim`` in rank order
    (blocks of one shape).  The backward gives this rank's block of the
    gradient: ``grad='sum'`` sums the gradients of the ranks first (a
    reduce-scatter: each rank used the whole for its own part of the
    work, as attention's queries of a sequence chunk use every key),
    ``grad='slice'`` takes this rank's own (every rank computed the same
    thing from the whole, as the replicated head after a vocabulary
    block's gather)."""
    if group is None:
        return x
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad={grad!r}: expected 'sum' or 'slice'")
    return _GatherCat.apply(x, group, dim, grad)
