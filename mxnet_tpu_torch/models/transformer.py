"""Transformer building blocks (counterpart of
``mxnet_tpu/models/transformer.py``), single device, eager.

The serving entry points (``forward_step_slots``,
``forward_prefill_slots``) mirror the reference's, with two deliberate
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
"""
from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..gluon.nn import GELU, Dense, Dropout, LayerNorm
from ..ops import dot_product_attention
from ..ops.paged import kv_quantize, paged_attention

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerBlock",
           "run_blocks"]

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


class MultiHeadAttention(HybridBlock):
    """Self-attention with separate q/k/v/out projections (the
    reference's parameter tree)."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self._causal = causal
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(units, in_units=units))
        self.dropout = Dropout(dropout) if dropout else None

    def _qkv(self, x):
        b, t = x.shape[0], x.shape[1]
        h, d = self._num_heads, self._head_dim
        return (self.q_proj(x).reshape(b, t, h, d),
                self.k_proj(x).reshape(b, t, h, d),
                self.v_proj(x).reshape(b, t, h, d))

    def _out(self, out):
        b, t = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, t, -1))

    def forward(self, x):
        q, k, v = self._qkv(x)
        out = self._out(dot_product_attention(q, k, v, causal=self._causal))
        if self.dropout is not None:
            out = self.dropout(out)
        return out

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
        Writes with no real target land in the trash column/page."""
        b, t = x.shape[0], x.shape[1]
        scale = 1.0 / (self._head_dim ** 0.5)
        q, k, v = self._qkv(x)
        ar = torch.arange(t, device=x.device, dtype=torch.int32)[None, :]
        cidx = ar.expand(b, t) if offset is None else offset[:, None] + ar
        if page_table is None:
            _write_rows(cache, slot_idx[:, None], cidx, k, v)
        else:
            trows = page_table[slot_idx.long()]
            _write_pages(cache, trows, cidx, k, v)
        if offset is None:
            out = dot_product_attention(q, k, v, causal=True)
        elif page_table is None:
            tmax = cache["k"].shape[1] - 1
            krow = cache["k"][slot_idx.long(), :tmax]
            vrow = cache["v"][slot_idx.long(), :tmax]
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


def _attention_step_slots(q, k_cache, v_cache, pos, scale):
    """One query per row: row s attends keys <= pos[s]."""
    keys = torch.arange(k_cache.shape[1], device=q.device)
    keep = keys[None, None, None, :] <= pos[:, None, None, None]
    return _masked_softmax_attention(q, k_cache, v_cache, keep, scale)


class PositionwiseFFN(HybridBlock):
    """Transformer FFN: Dense(hidden) → GELU → Dense(units)."""

    def __init__(self, units, hidden_size, dropout=0.0):
        super().__init__()
        self.fc1 = Dense(hidden_size, in_units=units)
        self.act = GELU()
        self.fc2 = Dense(units, in_units=hidden_size)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.fc2(self.act(self.fc1(x)))
        if self.dropout is not None:
            h = self.dropout(h)
        return h


def run_blocks(blocks, x):
    """Apply a stack of transformer layers in order."""
    for blk in blocks:
        x = blk(x)
    return x


class TransformerBlock(HybridBlock):
    """Pre-LN transformer layer (GPT-2 style)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=True, layer_norm_eps=1e-5):
        super().__init__()
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.attn = MultiHeadAttention(units, num_heads, dropout=dropout,
                                       causal=causal)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))

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
