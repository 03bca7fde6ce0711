"""GPT-2 language model (counterpart of ``mxnet_tpu/models/gpt2.py``):
the forward pass, the serving decode surface the engine drives
(slot and page caches, bucketed prefill, one decode step over every
slot) and a generate loop.  Token ids and positions are int32 at the
public functions; caches follow the parameter dtype.  The LM head is
tied to ``wte``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dropout, Embedding, LayerNorm
from .transformer import TransformerBlock, run_blocks

__all__ = ["GPT2Model", "get_gpt2"]

_CONFIGS = {
    # name: (layers, units, heads)
    "gpt2_124m": (12, 768, 12),
    "gpt2_355m": (24, 1024, 16),
    "gpt2_774m": (36, 1280, 20),
    "gpt2_1558m": (48, 1600, 25),
}


class GPT2Model(HybridBlock):
    """Decoder-only LM: tokens (B, T) int32 → logits (B, T, vocab)."""

    def __init__(self, vocab_size=50257, units=768, num_layers=12,
                 num_heads=12, max_length=1024, dropout=0.1,
                 layer_norm_eps=1e-5):
        super().__init__()
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.wte = Embedding(vocab_size, units)
        self.wpe = Embedding(max_length, units)
        self.drop = Dropout(dropout) if dropout else None
        blocks = []
        for i in range(num_layers):
            blk = TransformerBlock(units, 4 * units, num_heads,
                                   dropout=dropout, causal=True,
                                   layer_norm_eps=layer_norm_eps)
            self.add_module(f"h{i}", blk)
            blocks.append(blk)
        self.blocks = blocks
        self.ln_f = LayerNorm(epsilon=layer_norm_eps, in_channels=units)

    def _logits(self, x):
        # tied LM head: logits = x · wteᵀ
        return F.linear(x, self.wte.weight)

    def forward(self, tokens):
        t = tokens.shape[1]
        if t > self.max_length:
            raise ValueError(f"sequence length {t} exceeds max_length="
                             f"{self.max_length} (position table size)")
        pos = torch.arange(t, dtype=torch.int32, device=tokens.device)
        x = self.wte(tokens) + self.wpe(pos)[None]
        if self.drop is not None:
            x = self.drop(x)
        x = run_blocks(self.blocks, x)
        return self._logits(self.ln_f(x))

    # ------------------------------------------------------ serving surface
    def kv_heads(self):
        """(num_heads, head_dim) of the serving KV caches."""
        attn = self.blocks[0].attn
        return attn._num_heads, attn._head_dim

    def _cache_dtype(self):
        """Caches follow the parameter dtype (bf16 parameters → bf16
        caches, half the memory)."""
        dt = self.wte.weight.dtype
        return dt if dt in (torch.bfloat16, torch.float16,
                            torch.float32) else torch.float32

    def init_slot_cache(self, num_slots, max_length=None):
        """Persistent dense serving cache: per layer {'k','v'} of
        (num_slots, Tmax + 1, H, D) zeros on the parameters' device;
        column Tmax is the trash column that out-of-range writes land in
        and nothing reads."""
        t = max_length or self.max_length
        h, d = self.kv_heads()
        dev = self.wte.weight.device
        dt = self._cache_dtype()
        return [{"k": torch.zeros((num_slots, t + 1, h, d), dtype=dt,
                                  device=dev),
                 "v": torch.zeros((num_slots, t + 1, h, d), dtype=dt,
                                  device=dev)}
                for _ in self.blocks]

    def init_page_cache(self, num_pages, page_size, kv_quant=None):
        """Persistent paged serving cache.  ``num_pages`` counts the zero
        page, as in the reference (the engine passes its pool size + 1);
        one trash page is added past it, so each leaf holds
        ``num_pages + 1`` pages.  ``kv_quant='int8'`` stores int8 pages
        with float32 per-position-per-head scales in ``k_scale``/
        ``v_scale`` leaves of shape (N, ps, H, 1)."""
        h, d = self.kv_heads()
        dev = self.wte.weight.device
        n = num_pages + 1
        if kv_quant is None:
            dt = self._cache_dtype()
            return [{"k": torch.zeros((n, page_size, h, d), dtype=dt,
                                      device=dev),
                     "v": torch.zeros((n, page_size, h, d), dtype=dt,
                                      device=dev)}
                    for _ in self.blocks]
        if kv_quant != "int8":
            raise ValueError(f"kv_quant={kv_quant!r}: only 'int8' (or "
                             f"None for the float layout) is supported")

        def zeros(last, dt):
            return torch.zeros((n, page_size, h, last), dtype=dt,
                               device=dev)
        return [{"k": zeros(d, torch.int8), "k_scale": zeros(1, torch.float32),
                 "v": zeros(d, torch.int8), "v_scale": zeros(1, torch.float32)}
                for _ in self.blocks]

    @torch.no_grad()
    def prefill_slots(self, tokens, lens, caches, slot_idx, offset=None,
                      page_table=None, paged_kernel=False):
        """Admission prefill for a bucketed batch: tokens (B, Tb) int32
        right-padded, ``lens`` (B,) true lengths, ``slot_idx`` (B,) cache
        rows.  Writes every layer's K/V and returns the logits at each
        row's last real position (B, vocab) plus the (updated in place)
        caches.  ``offset`` (B,) makes row i a chunk at absolute
        positions [offset[i], offset[i] + Tb); ``page_table`` (S+1, P)
        selects the paged layout and ``paged_kernel`` its in-place read
        arm."""
        b, t = tokens.shape
        ar = torch.arange(t, dtype=torch.int32, device=tokens.device)
        if offset is None:
            pos = ar[None].expand(b, t)
        else:
            # clamp the embedding lookup only: padding columns past the
            # position table write to the trash target, and their
            # logits are never read
            pos = torch.clamp(offset[:, None] + ar[None],
                              max=self.max_length - 1)
        x = self.wte(tokens) + self.wpe(pos)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.forward_prefill_slots(x, cache, slot_idx, offset,
                                             page_table, paged_kernel)
        x = self.ln_f(x)
        last = x[torch.arange(b, device=x.device), lens.long() - 1]
        return self._logits(last), caches

    @torch.no_grad()
    def decode_step(self, tok, caches, pos, page_table=None,
                    paged_kernel=False):
        """One continuous-batching decode step over every slot: tok (S,)
        int32 last tokens at positions ``pos`` (S,) int32 → (logits
        (S, vocab), caches).  Free rows run too, parked at pos = Tmax so
        their writes land in the trash target."""
        s = tok.shape[0]
        x = self.wte(tok.reshape(s, 1)) + self.wpe(pos.reshape(s, 1))
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.forward_step_slots(x, cache, pos, page_table,
                                          paged_kernel)
        return self._logits(self.ln_f(x)).reshape(s, self.vocab_size), caches

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens, temperature=1.0, top_k=0,
                 seed=0):
        """Autoregressive generation with a dense KV cache: one batched
        prefill, then one decode step per token.  ``temperature <= 0`` is
        greedy argmax; otherwise the seeded sampler of
        :mod:`mxnet_tpu_torch.serving.sampling`.  Returns (B, Tp + new)
        int32 on the model's device."""
        from ..serving.sampling import sample_tokens
        dev = self.wte.weight.device
        prompt = torch.as_tensor(
            prompt if isinstance(prompt, torch.Tensor) else
            np.asarray(prompt), device=dev).to(torch.int32)
        b, tp = prompt.shape
        total = tp + int(max_new_tokens)
        if total > self.max_length:
            raise ValueError(f"prompt+new = {total} exceeds max_length="
                             f"{self.max_length}")
        caches = self.init_slot_cache(b, total)
        temp = torch.full((b,), max(float(temperature), 0.0), device=dev)
        topk = torch.full((b,), min(int(top_k), self.vocab_size),
                          dtype=torch.int32, device=dev)
        topp = torch.ones((b,), device=dev)
        seeds = [int(seed)] * b
        lens = torch.full((b,), tp, dtype=torch.int32, device=dev)
        logits, caches = self.prefill_slots(
            prompt, lens, caches, torch.arange(b, dtype=torch.int32,
                                               device=dev))
        tok = sample_tokens(logits, temp, topk, topp, seeds, [tp - 1] * b)
        out = [prompt, tok[:, None]]
        for t in range(tp, total - 1):
            pos = torch.full((b,), t, dtype=torch.int32, device=dev)
            logits, caches = self.decode_step(tok, caches, pos)
            tok = sample_tokens(logits, temp, topk, topp, seeds, [t] * b)
            out.append(tok[:, None])
        return torch.cat(out, dim=1)


def get_gpt2(name="gpt2_124m", device=None, **kwargs):
    """A GPT-2 of a published size (``gpt2_124m``/``355m``/``774m``/
    ``1558m``), fields overridable by ``kwargs``, to be initialized on
    ``device`` (default: the current CUDA device; raises without one —
    pass ``device='cpu'`` for the CPU)."""
    dev = resolve_device(device)
    layers, units, heads = _CONFIGS[name]
    cfg = dict(units=units, num_layers=layers, num_heads=heads)
    cfg.update(kwargs)
    net = GPT2Model(**cfg)
    net._device = dev
    return net
