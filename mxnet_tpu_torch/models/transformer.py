"""Transformer building blocks (counterpart of
``mxnet_tpu/models/transformer.py``), eager.

**Tensor parallelism.**  Once ``parallel.shard_params`` has kept each
rank's block of the weights annotated ``heads`` or ``mlp`` (over a mesh
with ``tp`` above 1), the layers run Megatron-LM's split, the
collectives GSPMD inserts in the reference written out: ``q_proj``,
``k_proj``, ``v_proj`` and ``fc1`` are column-parallel (each rank
computes its H/tp heads, or its share of the hidden units, from the
whole input, entered through ``collectives.copy_to``), ``out_proj`` and
``fc2`` row-parallel (each rank's partial product, summed over ``tp`` by
``collectives.reduce_from``, then the replicated bias added once).  The
attention kernels (B1-B3) run on the rank's heads, and so do ring and
Ulysses attention under ``sp``.

**Masked, cross and dropout attention under ``sp``.**  The reference
attends over the global arrays under GSPMD, on its plain path (its
dispatch refuses masks to flash).  Here each rank all-gathers K, V and
the key mask over ``sp`` (cross-attention: the keys and values of the
memory's chunks), and its query chunk attends through
``dot_product_attention``'s plain path with the causal part written out
at global positions; the gather's backward reduce-scatters dK and dV
(:func:`~mxnet_tpu_torch.parallel.collectives.gather_cat`).  A mask is
a key mask there, (B or 1, 1 or H, 1, T_chunk): a mask with a query
axis has no chunk to gather and raises.

The serving entry points (``forward_step_slots``,
``forward_prefill_slots``, the speculative drafter's read-only
``forward_step_window``) mirror the reference's, with two deliberate
differences in how caches are updated:

- **In place.**  The reference returns new cache arrays (jax is
  functional); here the caches are updated in place with ``index_put_``
  and the same dict is returned, so a step never copies a cache.
- **Trash targets instead of dropped writes.**  The reference relies on
  jax dropping out-of-bounds scatters: parked decode rows sit at
  ``pos = Tmax`` and targetless page writes go to ``zero_page + 1``.
  torch raises on such an index on the CPU and device-asserts on CUDA.
  So every cache here carries one extra target that nothing ever reads:
  a dense cache row has ``Tmax + 1`` positions (column ``Tmax`` is the
  trash column, never attended), and a page pool has two pages past the
  ``N`` real ones — page ``N`` is the zero page (read by unassigned table
  entries, never written, so it reads as exact zeros) and page ``N + 1``
  is the trash page every targetless write lands in.

:func:`run_blocks` takes the reference's ``remat`` (``transformer.py:
710-752``): each layer runs under ``torch.utils.checkpoint`` and is
recomputed during backward, with the forward's dropout masks replayed
(see :func:`_remat_layer`); under ``'dots'`` the recomputation reads the
products' kept outputs back (:mod:`~mxnet_tpu_torch.ops.dots`).
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch
import torch.utils.checkpoint as _ckpt

from .. import amp as _amp
from .. import base as _base
from .. import parallel as _par
from .. import random as _random
from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..gluon.nn import GELU, Dense, Dropout, LayerNorm
from ..ndarray.ops import ACTIVATION_FNS as _ACTIVATIONS
from ..ops import dot_product_attention
from ..ops import dots as _dots
from ..ops.paged import kv_quantize, paged_attention
from ..parallel import collectives as _coll
from ..parallel.sharding import annotate, block_mesh

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerBlock",
           "TransformerEncoderLayer", "run_blocks", "copy_cache_rows",
           "seq_offset", "tp_group", "layer_tp_group", "row_parallel",
           "no_seq_parallel",
           "seq_first"]

_NEG = -1e30


def _write_pages(cache, page_table_rows, cidx, k, v):
    """Scatter K/V (B, T, H, D) at absolute positions ``cidx`` (B, T)
    through per-row page tables ``page_table_rows`` (B, P).  Positions
    past Tmax, columns in a logical page the row never claimed (the
    zero page) and parked rows all land in the trash page."""
    n_pages, ps = cache["k"].shape[0], cache["k"].shape[1]
    zero_page, trash = n_pages - 2, n_pages - 1
    p = page_table_rows.shape[1]
    tmax = p * ps
    lp = torch.clamp(cidx // ps, max=p - 1).long()
    mapped = torch.gather(page_table_rows, 1, lp)
    phys = torch.where((cidx < tmax) & (mapped != zero_page), mapped,
                       torch.full_like(mapped, trash)).long()
    off = (cidx % ps).long()
    if "k_scale" in cache:
        kq, ksc = kv_quantize(k)
        vq, vsc = kv_quantize(v)
        cache["k"].index_put_((phys, off), kq)
        cache["v"].index_put_((phys, off), vq)
        cache["k_scale"].index_put_((phys, off), ksc)
        cache["v_scale"].index_put_((phys, off), vsc)
    else:
        cache["k"].index_put_((phys, off), k.to(cache["k"].dtype))
        cache["v"].index_put_((phys, off), v.to(cache["v"].dtype))


def _write_rows(cache, ridx, cidx, k, v):
    """Scatter K/V (B, T, H, D) into dense rows ``ridx`` (B, 1) at
    positions ``cidx``; positions >= Tmax land in the trash column."""
    tmax = cache["k"].shape[1] - 1
    col = torch.clamp(cidx, max=tmax).long()
    cache["k"].index_put_((ridx.long(), col), k.to(cache["k"].dtype))
    cache["v"].index_put_((ridx.long(), col), v.to(cache["v"].dtype))


def _gather_rows(cache, table_rows):
    """Dense (B, P*ps, H, D) rows of float32/float K/V read back through
    the page tables, dequantized when the pages are int8 — the gather
    read arm."""
    krow = _paged_rows(cache["k"], table_rows)
    vrow = _paged_rows(cache["v"], table_rows)
    if "k_scale" in cache:
        krow = krow.float() * _paged_rows(cache["k_scale"], table_rows)
        vrow = vrow.float() * _paged_rows(cache["v_scale"], table_rows)
    return krow, vrow


def tp_group(weight):
    """The ``tp`` group over which ``weight`` is split into this rank's
    block (raises outside its mesh), or None where it is whole."""
    mesh = block_mesh(weight, "tp")
    return mesh.group("tp") if mesh is not None else None


def layer_tp_group(layer):
    """:func:`tp_group` of ``layer``'s float weight, or None where it has
    none (an int8 ``QuantizedDense``, which is never split)."""
    weight = layer._parameters.get("weight")
    return None if weight is None else tp_group(weight)


def row_parallel(dense, x, group):
    """``dense`` whose weight is this rank's block of input columns,
    applied to this rank's part ``x`` of its input: the partial products
    summed over ``group``, then the (replicated) bias added once."""
    x, w, b = _amp.cast("FullyConnected", x, dense.weight, dense.bias)
    y = _coll.reduce_from(_dots.linear(x, w, None), group)
    return y if b is None else y + b


class MultiHeadAttention(HybridBlock):
    """Multi-head attention with separate q/k/v/out projections (the
    reference's parameter tree): self-attention over ``x``, or
    cross-attention with ``memory`` (queries from ``x``, keys and values
    from ``memory``: the encoder-decoder attention of NMT).
    ``attention_dropout`` drops attention weights in training; above 0
    it sends attention to the reference path, as the reference's
    dispatch does.

    Under a mesh with ``sp`` above 1 (``parallel.use_mesh``), ``x`` is
    this rank's sequence chunk and self-attention without a mask or
    attention dropout runs sequence-parallel, as the reference routes it
    (``transformer.py:75-113``): ``seq_parallel='ring'`` (default, or
    ``MXNET_TPU_SEQ_PARALLEL``) through ``ops.ring_attention``,
    ``'ulysses'`` through ``ops.ulysses_attention`` where the local heads
    divide by |sp| (else the ring, with the reference's warning).  Under
    ``tp`` (projections split by ``parallel.shard_params``) it computes
    the rank's H/tp heads (module docstring)."""

    def __init__(self, units, num_heads, dropout=0.0, attention_dropout=0.0,
                 use_bias=True, causal=False, seq_parallel=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        if seq_parallel is None:
            seq_parallel = os.environ.get("MXNET_TPU_SEQ_PARALLEL", "ring")
        if seq_parallel not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_parallel must be 'ring' or 'ulysses', "
                f"got {seq_parallel!r}")
        self._seq_parallel = seq_parallel
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self._causal = causal
        self._att_dropout = attention_dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            d = Dense(units, use_bias=use_bias, flatten=False,
                      in_units=units)
            if name == "out_proj":
                annotate(d.weight, "embed", "heads")
                if d.bias is not None:
                    annotate(d.bias, "norm")
            else:
                annotate(d.weight, "heads", "embed")
                if d.bias is not None:
                    annotate(d.bias, "heads")
            setattr(self, name, d)
        self.dropout = Dropout(dropout) if dropout else None

    def local_heads(self) -> int:
        """This rank's heads: all of them, or H/tp of a split projection
        (the rows of ``q_proj``'s float or int8 weight over the head
        dimension; read without a mesh, as the serving caches are
        sized)."""
        w = self.q_proj._parameters.get("weight")
        if w is None:
            w = self.q_proj.qweight
        return w.shape[0] // self._head_dim

    def _qkv(self, x, memory=None):
        group = layer_tp_group(self.q_proj)
        x = _coll.copy_to(x, group)
        kv = x if memory is None else _coll.copy_to(memory, group)
        b, t, tk = x.shape[0], x.shape[1], kv.shape[1]
        d, h = self._head_dim, self.local_heads()
        return (self.q_proj(x).reshape(b, t, h, d),
                self.k_proj(kv).reshape(b, tk, h, d),
                self.v_proj(kv).reshape(b, tk, h, d))

    def _out(self, out):
        b, t = out.shape[0], out.shape[1]
        out = out.reshape(b, t, -1)
        group = layer_tp_group(self.out_proj)
        if group is None:
            return self.out_proj(out)
        return row_parallel(self.out_proj, out, group)

    def forward(self, x, mask=None, memory=None):
        q, k, v = self._qkv(x, memory)
        out = None
        if mask is None and memory is None and self._att_dropout == 0.0:
            out = _seq_parallel_attention(self, q, k, v)
        elif _sp_size() > 1:
            out = _gathered_attention(self, q, k, v, mask)
        if out is None:
            out = dot_product_attention(q, k, v, causal=self._causal,
                                        mask=mask, dropout=self._att_dropout)
        out = self._out(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out

    def forward_step(self, x, cache, idx):
        """Incremental decode: x (B, 1, U) at position ``idx`` against the
        dense cache {'k','v': (B, Tmax, H, D)}, written in place at
        ``idx``; attends positions <= idx.  Returns (out (B, 1, U),
        cache).  Inference only."""
        b = x.shape[0]
        q, k_new, v_new = self._qkv(x)
        cache["k"][:, idx] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v_new[:, 0].to(cache["v"].dtype)
        pos = torch.full((b,), int(idx), dtype=torch.int32, device=x.device)
        out = _attention_step_slots(q, cache["k"], cache["v"], pos,
                                    1.0 / (self._head_dim ** 0.5))
        return self._out(out), cache

    def forward_prefill(self, x, cache):
        """Batched cache fill: causal attention over the prompt x
        (B, T, U) in one pass, writing K/V for positions [0, T) into the
        dense cache in place.  Returns (out (B, T, U), cache).
        Inference only."""
        t = x.shape[1]
        q, k, v = self._qkv(x)
        cache["k"][:, :t] = k.to(cache["k"].dtype)
        cache["v"][:, :t] = v.to(cache["v"].dtype)
        out = dot_product_attention(q, k, v, causal=True)
        return self._out(out), cache

    def forward_step_slots(self, x, cache, pos, page_table=None,
                           paged_kernel=False):
        """Continuous-batching decode: x (S, 1, U), row s at its own
        position ``pos[s]`` (S,) int32.  Writes K/V at position pos[s]
        of row s (dense) or through ``page_table`` (S, P) (paged), then
        attends keys <= pos[s].  Parked rows (pos = Tmax) write to the
        trash target.  ``paged_kernel`` reads the pages in place through
        :func:`~mxnet_tpu_torch.ops.paged.paged_attention`; otherwise the
        rows are gathered back (the gather arm)."""
        s = x.shape[0]
        scale = 1.0 / (self._head_dim ** 0.5)
        q, k_new, v_new = self._qkv(x)
        if page_table is None:
            rows = torch.arange(s, device=x.device)[:, None]
            _write_rows(cache, rows, pos[:, None], k_new, v_new)
            tmax = cache["k"].shape[1] - 1
            krow, vrow = cache["k"][:s, :tmax], cache["v"][:s, :tmax]
        else:
            _write_pages(cache, page_table, pos[:, None], k_new, v_new)
            if paged_kernel:
                quant = "k_scale" in cache
                out = paged_attention(
                    q, cache["k"], cache["v"], page_table, pos[:, None],
                    k_scale=cache["k_scale"] if quant else None,
                    v_scale=cache["v_scale"] if quant else None,
                    scale=scale)
                return self._out(out), cache
            krow, vrow = _gather_rows(cache, page_table)
        out = _attention_step_slots(q, krow, vrow, pos, scale)
        return self._out(out), cache

    def forward_prefill_slots(self, x, cache, slot_idx, offset=None,
                              page_table=None, paged_kernel=False):
        """Bucketed admission prefill: x (B, Tb, U) right-padded prompts;
        row i's K/V for positions [0, Tb) land in cache row
        ``slot_idx[i]`` (dense) or through ``page_table[slot_idx[i]]``
        (paged).  Full-prompt prefill (``offset=None``) attends the
        chunk's own fresh K/V with causal attention — the flash kernel on
        the card at T >= 256.  With ``offset`` (B,) row i's tokens sit at
        ``[offset[i], offset[i] + Tb)`` behind K/V already in its cache
        row, and each query attends every cached key <= its position.
        Writes with no real target land in the trash column/page.
        ``slot_idx=None`` means row i is slot i (the verify window over
        every slot): the cache rows are read as a slice, not a gather."""
        b, t = x.shape[0], x.shape[1]
        scale = 1.0 / (self._head_dim ** 0.5)
        q, k, v = self._qkv(x)
        ar = torch.arange(t, device=x.device, dtype=torch.int32)[None, :]
        cidx = ar.expand(b, t) if offset is None else offset[:, None] + ar
        rows = slice(0, b) if slot_idx is None else slot_idx.long()
        if page_table is None:
            ridx = torch.arange(b, device=x.device) if slot_idx is None \
                else slot_idx
            _write_rows(cache, ridx[:, None], cidx, k, v)
        else:
            trows = page_table[rows]
            _write_pages(cache, trows, cidx, k, v)
        if offset is None:
            out = dot_product_attention(q, k, v, causal=True)
        elif page_table is None:
            tmax = cache["k"].shape[1] - 1
            krow = cache["k"][rows, :tmax]
            vrow = cache["v"][rows, :tmax]
            out = _attention_chunk(q, krow, vrow, cidx, scale)
        elif paged_kernel:
            quant = "k_scale" in cache
            out = paged_attention(
                q, cache["k"], cache["v"], trows, cidx.contiguous(),
                k_scale=cache["k_scale"] if quant else None,
                v_scale=cache["v_scale"] if quant else None, scale=scale)
        else:
            krow, vrow = _gather_rows(cache, trows)
            out = _attention_chunk(q, krow, vrow, cidx, scale)
        return self._out(out), cache


    def cache_rows(self, cache, s, page_table=None):
        """The first ``s`` rows of ``cache`` as dense (S, Tmax, H, D) K
        and V, read back through ``page_table`` (dequantized to float32
        for int8 pages) in the paged layout: what the draft attends.
        The drafter reads them once for its k steps."""
        if page_table is None:
            tmax = cache["k"].shape[1] - 1
            return cache["k"][:s, :tmax], cache["v"][:s, :tmax]
        return _gather_rows(cache, page_table[:s])

    def forward_step_window(self, x, rows, pos, win_k, win_v, i):
        """Read-only draft step: like :meth:`forward_step_slots`, but the
        new K/V land in the per-layer window buffers ``win_k``/``win_v``
        (S, W, H, D) at column ``i`` (in place) and the cache is never
        written, so an abandoned draft leaves nothing behind.  Row s
        consumes a token at position ``pos[s] + i`` and attends the
        keys ``< pos[s]`` of its cache row (``rows``, from
        :meth:`cache_rows`) plus window columns ``<= i``.  The
        reference's signature takes the cache and the page table
        instead of their rows."""
        q, k_new, v_new = self._qkv(x)
        win_k[:, i] = k_new[:, 0].to(win_k.dtype)
        win_v[:, i] = v_new[:, 0].to(win_v.dtype)
        out = _attention_step_window(q, rows[0], rows[1], win_k, win_v, pos,
                                     i, 1.0 / (self._head_dim ** 0.5))
        return self._out(out)


def copy_cache_rows(caches, src, dst, length):
    """Copy positions ``[0, length)`` of row ``src`` into row ``dst`` of
    every leaf of every layer, the rest of ``dst`` untouched: the dense
    prefix cache's pool-to-slot and slot-to-pool copy.  In the paged
    layout axis 1 is the page's, so the same copy is a prefix hit's
    partial tail page (int8 scales included).  ``src``, ``dst`` and
    ``length`` are device scalars (or ints): one masked copy of whole
    rows, the same launches for every length and no host read, the
    reference's one program with src/dst/length traced."""
    leaf = caches[0]["k"]
    dev = leaf.device

    def idx(x):
        return torch.as_tensor(x, device=dev).to(torch.int64).reshape(1)
    src, dst, length = idx(src), idx(dst), idx(length)
    keep = torch.arange(leaf.shape[1], device=dev) < length
    for cache in caches:
        for a in cache.values():
            m = keep.reshape((1, -1) + (1,) * (a.dim() - 2))
            a.index_copy_(0, dst, torch.where(m, a.index_select(0, src),
                                              a.index_select(0, dst)))


_WARNED_ULYSSES_FALLBACK = False


_SP_OFF = threading.local()


@contextlib.contextmanager
def no_seq_parallel():
    """Run whole sequences under a mesh with ``sp`` above 1: inside, the
    models see no sequence axis (no chunk offset, no ring), while their
    ``tp`` blocks still meet through the mesh (inference of a net trained
    under ``sp``, as ``TransformerNMT.translate``)."""
    prev = getattr(_SP_OFF, "on", False)
    _SP_OFF.on = True
    try:
        yield
    finally:
        _SP_OFF.on = prev


def _sp_mesh():
    """The current mesh where its ``sp`` axis is live, else None."""
    mesh = _par.current_mesh()
    if mesh is None or _par.axis_size(mesh, "sp") == 1 or \
            getattr(_SP_OFF, "on", False):
        return None
    return mesh


def seq_offset(t: int) -> int:
    """The first position of this rank's sequence chunk of length ``t``
    under the current mesh's ``sp`` axis (0 without one): the models add
    it to the positions they embed."""
    mesh = _sp_mesh()
    return 0 if mesh is None else mesh.axis_index("sp") * t


def _sp_size() -> int:
    mesh = _sp_mesh()
    return 1 if mesh is None else _par.axis_size(mesh, "sp")


def seq_first(x):
    """``x[:, 0]`` of the whole sequence: under ``sp`` the first rank's
    first position, summed over ``sp`` with zeros from the others
    (``collectives.psum``, so each rank's share of the gradient returns
    to the first rank's chunk)."""
    mesh = _sp_mesh()
    first = x[:, 0]
    if mesh is None:
        return first
    if mesh.axis_index("sp"):
        first = first * 0
    return _coll.psum(first, mesh.group("sp"))


def _gathered_attention(attn, q, k, v, mask):
    """Attention of this rank's query chunk over the whole sequence's keys
    under ``sp`` (module docstring): K and V gathered over ``sp``, the
    causal part at global positions, the plain path.  ``mask`` is a key
    mask of this rank's chunk ``(B, 1, 1, T_chunk)`` (gathered over
    ``sp``), or this rank's query rows over the whole key axis ``(B, 1,
    T_chunk, T)`` (the local-chunk convention of sequence-parallel ops),
    ``B`` possibly 1."""
    mesh = _sp_mesh()
    group = mesh.group("sp")
    k = _coll.gather_cat(k, group, 1)
    v = _coll.gather_cat(v, group, 1)
    b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
    full = None
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
        shape = tuple(mask.shape)
        batch = mask.dim() == 4 and shape[0] in (1, b) and shape[1] == 1
        if batch and shape[2] == tq and shape[3] == tk:
            full = mask.bool()
        elif batch and shape[2] == 1 and shape[3] * _sp_size() == tk:
            full = _coll.gather_cat(mask.to(torch.uint8), group, 3).bool()
        else:
            raise MXNetError(
                f"attention under an sp mesh takes a key mask ({b}, 1, 1, "
                f"{tk // _sp_size()}) of this rank's chunk or this rank's "
                f"query rows over the whole key axis ({b}, 1, {tq}, {tk}); "
                f"got a mask of shape {shape}")
    if attn._causal:
        qpos = torch.arange(tq, device=q.device) + mesh.axis_index("sp") * tq
        kpos = torch.arange(tk, device=q.device)
        c = (kpos[None, :] <= qpos[:, None])[None, None]
        full = c if full is None else full & c
    return dot_product_attention(q, k, v, mask=full,
                                 dropout=attn._att_dropout)


def _seq_parallel_attention(attn, q, k, v):
    """Attention of this rank's sequence chunk under an ``sp`` mesh (ring
    or Ulysses), or None where there is none to run."""
    sp = _sp_size()
    if sp == 1:
        return None
    mesh = _sp_mesh()
    h = attn._num_heads
    if attn._seq_parallel == "ulysses":
        # this rank's heads: H / |tp| under tensor parallelism
        if q.shape[2] % sp == 0:
            from ..ops.ulysses import ulysses_attention
            return ulysses_attention(q, k, v, causal=attn._causal,
                                     mesh=mesh)
        global _WARNED_ULYSSES_FALLBACK
        if not _WARNED_ULYSSES_FALLBACK:
            import logging
            logging.warning(
                "seq_parallel='ulysses' needs local heads (%d/|tp|) "
                "divisible by |sp|=%d; falling back to ring attention", h,
                sp)
            _WARNED_ULYSSES_FALLBACK = True
    from ..ops.ring import ring_attention
    return ring_attention(q, k, v, causal=attn._causal, mesh=mesh)


def _paged_rows(pages, table_rows):
    """Gather per-slot pages back into contiguous rows: (N+2, ps, H, D)
    pages and (B, P) tables → (B, P*ps, H, D), the dense row view, so
    the masked attentions are shared verbatim between the layouts."""
    b, p = table_rows.shape
    g = pages[table_rows.long()]                     # (B, P, ps, H, D)
    return g.reshape(b, p * g.shape[2], g.shape[3], g.shape[4])


def _masked_softmax_attention(q, k_rows, v_rows, keep, scale):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_rows.float()) * scale
    logits = torch.where(keep, logits, torch.full_like(logits, _NEG))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v_rows.dtype), v_rows)


def _attention_chunk(q, k_rows, v_rows, qpos, scale):
    """Queries (B, Tq, H, D) at absolute positions ``qpos`` (B, Tq)
    against full cache rows (B, Tmax, H, D): query (b, i) attends keys
    <= qpos[b, i]."""
    keys = torch.arange(k_rows.shape[1], device=q.device)
    keep = keys[None, None, None, :] <= qpos[:, None, :, None]
    return _masked_softmax_attention(q, k_rows, v_rows, keep, scale)


def _attention_step_window(q, k_cache, v_cache, k_win, v_win, pos, i,
                           scale):
    """A draft step over [cache row, speculation window]: row s attends
    cache keys ``< pos[s]`` (the consumed token's own K/V is in window
    column 0) and window columns ``<= i``."""
    keys = torch.arange(k_cache.shape[1], device=q.device)
    keep_c = keys[None, None, None, :] < pos[:, None, None, None]
    cols = torch.arange(k_win.shape[1], device=q.device)
    keep_w = (cols <= i)[None, None, None, :].expand(
        keep_c.shape[0], 1, 1, -1)
    keep = torch.cat([keep_c, keep_w], dim=-1)
    vals = torch.cat([v_cache, v_win.to(v_cache.dtype)], dim=1)
    return _masked_softmax_attention(
        q, torch.cat([k_cache, k_win.to(k_cache.dtype)], dim=1), vals,
        keep, scale)


def _attention_step_slots(q, k_cache, v_cache, pos, scale):
    """One query per row: row s attends keys <= pos[s]."""
    keys = torch.arange(k_cache.shape[1], device=q.device)
    keep = keys[None, None, None, :] <= pos[:, None, None, None]
    return _masked_softmax_attention(q, k_cache, v_cache, keep, scale)


class PositionwiseFFN(HybridBlock):
    """Transformer FFN: Dense(hidden) → activation (GELU, or any
    ``Activation`` type) → Dense(units); under ``tp`` ``fc1`` is
    column-parallel and ``fc2`` row-parallel (module docstring)."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 use_bias=True, **kwargs):
        super().__init__(**kwargs)
        self.fc1 = Dense(hidden_size, use_bias=use_bias, flatten=False,
                         in_units=units)
        annotate(self.fc1.weight, "mlp", "embed")
        if self.fc1.bias is not None:
            annotate(self.fc1.bias, "mlp")
        self.act = GELU() if activation == "gelu" else None
        self._activation = activation
        self.fc2 = Dense(units, use_bias=use_bias, flatten=False,
                         in_units=hidden_size)
        annotate(self.fc2.weight, "embed", "mlp")
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        group = layer_tp_group(self.fc1)
        h = self.fc1(_coll.copy_to(x, group))
        h = self.act(h) if self.act is not None else \
            _ACTIVATIONS[self._activation](h)
        h = self.fc2(h) if group is None else \
            row_parallel(self.fc2, h, group)
        if self.dropout is not None:
            h = self.dropout(h)
        return h


def _call(blk, x, mask, memory=None):
    if memory is not None:
        return blk(x, memory, mask)
    return blk(x) if mask is None else blk(x, mask)


def _own_aux(blk, x, mask, memory=None):
    """``blk``'s output and the aux losses it recorded, the collector's
    earlier entries left in place."""
    outer = _base.pop_aux_losses()
    try:
        out = _call(blk, x, mask, memory)
    finally:
        mine = _base.pop_aux_losses()
        for a in outer:
            _base.record_aux_loss(a)
    return out, mine


def _remat_layer(blk, x, mask, remat, memory=None):
    """One layer under ``torch.utils.checkpoint`` (non-reentrant).  With
    ``remat='dots'`` the layer's products keep their outputs and the
    recomputation reads them back instead of multiplying again
    (:mod:`~mxnet_tpu_torch.ops.dots`, the reference's
    ``checkpoint_dots``, ``transformer.py:696-698``).
    A decoder layer takes ``memory`` (the encoder's output) as a second
    input of the checkpoint: it is saved, not recomputed, and its
    gradient flows out of the recomputation.

    The recomputation runs during backward, on autograd's device thread
    for CUDA tensors, so it reinstates what the forward read from its
    thread: the training and recording flags, aux collection, the amp
    policy, and the device generator's state, replayed so dropout draws
    the same masks (the reference's "IDENTICAL dropout masks") and
    afterwards put back, so later draws are those of a run without
    remat.  The layer's aux losses leave the checkpoint as outputs and
    are recorded once; those of the recomputation are dropped.  B1
    (``ops/flash.py``, a ctypes launch) is no product: it runs again in
    the recomputation under either form, as the reference's policy
    saves no Pallas call's output either.

    Inside a graphed program (``utils/graphs.py``) the generator's
    state cannot be read or set on the host: the layer's forward draws
    from one of its program's twin states and the recomputation from
    the other (:class:`~mxnet_tpu_torch.random.GraphDraws`), which the
    program aligns before each replay.  ``torch.utils.checkpoint`` keeps
    no RNG state of its own (``preserve_rng_state=False``): the port
    never draws from torch's global generators."""
    dev = x.device
    draws = _random.graph_draws()
    if draws is not None:
        fwd_state, rec_state = draws.twin()
        fwd_rng = functools.partial(_random.drawing_from, dev, fwd_state)
        rec_rng = functools.partial(_random.drawing_from, dev, rec_state)
    else:
        rng = _random.generator(dev).get_state()
        fwd_rng = contextlib.nullcontext
        rec_rng = functools.partial(_random.replay, dev, rng)
    flags = (_base.is_training(), _base.is_recording(),
             _base.aux_collection_active(), _amp.current_policy())
    forward_done = []
    products = []               # the 'dots' layer's kept outputs

    def keep(replay):
        return _dots.keep(products, replay) if remat == "dots" else \
            contextlib.nullcontext()

    def run(h, mem):
        if not forward_done:
            forward_done.append(True)
            with keep(False), fwd_rng():
                out, aux = _own_aux(blk, h, mask, mem)
            return (out, *aux)
        prev = (_base.set_training(flags[0]), _base.set_recording(flags[1]),
                _base.set_aux_collection(flags[2]))
        try:
            with _amp.policy_scope(flags[3]), rec_rng(), keep(True):
                _own_aux(blk, h, mask, mem)
        finally:
            _base.set_training(prev[0])
            _base.set_recording(prev[1])
            _base.set_aux_collection(prev[2])

    out, *aux = _ckpt.checkpoint(run, x, memory, use_reentrant=False,
                                 preserve_rng_state=False)
    for a in aux:
        _base.record_aux_loss(a)
    return out


def run_blocks(blocks, x, mask=None, scan=None, remat=False):
    """Apply a stack of transformer layers in order.

    ``remat`` (the reference's): ``True`` recomputes each layer during
    backward instead of keeping its activations (``_remat_layer``);
    ``"dots"`` keeps the matmul outputs and recomputes the rest.  It
    applies only where a graph is built (grad enabled).  ``scan`` is
    accepted for the reference's signature and has no effect: the port
    runs layers eagerly, and ``lax.scan`` exists to compile one body."""
    if remat not in (False, None, True, "dots"):
        raise MXNetError(f"remat={remat!r}: expected False, True or "
                         "'dots'")
    if remat and torch.is_grad_enabled():
        for blk in blocks:
            x = _remat_layer(blk, x, mask, remat)
        return x
    for blk in blocks:
        x = _call(blk, x, mask)
    return x


class TransformerBlock(HybridBlock):
    """Pre-LN transformer layer (GPT-2 style)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, causal=True, layer_norm_eps=1e-5):
        super().__init__()
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.attn = MultiHeadAttention(units, num_heads, dropout=dropout,
                                       attention_dropout=attention_dropout,
                                       causal=causal)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.ffn(self.ln2(x))

    def forward_step(self, x, cache, idx):
        """Incremental decode through the block (see
        :meth:`MultiHeadAttention.forward_step`)."""
        a, cache = self.attn.forward_step(self.ln1(x), cache, idx)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache

    def forward_prefill(self, x, cache):
        """Batched cache fill through the block (see
        :meth:`MultiHeadAttention.forward_prefill`)."""
        a, cache = self.attn.forward_prefill(self.ln1(x), cache)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache

    def forward_step_slots(self, x, cache, pos, page_table=None,
                           paged_kernel=False):
        a, cache = self.attn.forward_step_slots(self.ln1(x), cache, pos,
                                                page_table, paged_kernel)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache

    def forward_prefill_slots(self, x, cache, slot_idx, offset=None,
                              page_table=None, paged_kernel=False):
        a, cache = self.attn.forward_prefill_slots(
            self.ln1(x), cache, slot_idx, offset, page_table, paged_kernel)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache

    def forward_step_window(self, x, rows, pos, win_k, win_v, i):
        x = x + self.attn.forward_step_window(self.ln1(x), rows, pos, win_k,
                                              win_v, i)
        return x + self.ffn(self.ln2(x))


class TransformerEncoderLayer(TransformerBlock):
    """Bidirectional (BERT-style) pre-LN layer: no causal mask."""

    def __init__(self, units, hidden_size, num_heads, **kwargs):
        super().__init__(units, hidden_size, num_heads, causal=False,
                         **kwargs)
