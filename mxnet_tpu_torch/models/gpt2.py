"""GPT-2 language model (counterpart of ``mxnet_tpu/models/gpt2.py``):
the forward pass, the serving decode surface the engine drives
(slot and page caches, bucketed and chunked prefill, one decode step
over every slot, the speculative verify window and early-exit drafter)
and a generate loop.  Token ids and positions are int32 at the
public functions; caches follow the parameter dtype.  The LM head is
tied to ``wte``.  The reference's routed family is here too:
``num_experts`` puts an :class:`~.moe.MoETransformerBlock` at every
``moe_every``-th layer, whose router aux losses ``gpt2_lm_loss`` adds;
``remat`` recomputes layers in backward (:func:`.transformer.run_blocks`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import amp as _amp
from .. import base as _base
from ..base import torch_dtype
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dropout, Embedding, LayerNorm
from ..ndarray.ndarray import NDArray
from ..ndarray.ops import _as_nd, invoke
from ..parallel.sharding import annotate
from .moe import MoETransformerBlock
from .transformer import TransformerBlock, run_blocks, seq_offset

__all__ = ["GPT2Model", "get_gpt2", "gpt2_lm_loss"]

_CONFIGS = {
    # name: (layers, units, heads)
    "gpt2_124m": (12, 768, 12),
    "gpt2_355m": (24, 1024, 16),
    "gpt2_774m": (36, 1280, 20),
    "gpt2_1558m": (48, 1600, 25),
}


def _dense_blocks_only(net):
    if any(type(b) is not TransformerBlock for b in net.blocks):
        raise ValueError("incremental decoding supports dense GPT-2 "
                         "blocks only (MoE routing is a training-time "
                         "layout)")


class GPT2Model(HybridBlock):
    """Decoder-only LM: tokens (B, T) int32 → logits (B, T, vocab)."""

    def __init__(self, vocab_size=50257, units=768, num_layers=12,
                 num_heads=12, max_length=1024, dropout=0.1,
                 layer_norm_eps=1e-5, num_experts=0, moe_every=2,
                 moe_top_k=2, moe_capacity_factor=1.25, scan_layers=None,
                 remat=False):
        super().__init__()
        self._scan_layers = scan_layers
        self._remat = remat
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.wte = Embedding(vocab_size, units)
        annotate(self.wte.weight, "vocab", "embed")
        self.wpe = Embedding(max_length, units)
        annotate(self.wpe.weight, "seq", "embed")
        self.drop = Dropout(dropout) if dropout else None
        blocks = []
        for i in range(num_layers):
            if num_experts and i % moe_every == moe_every - 1:
                blk = MoETransformerBlock(
                    units, 4 * units, num_heads, num_experts,
                    top_k=moe_top_k, capacity_factor=moe_capacity_factor,
                    dropout=dropout, causal=True,
                    layer_norm_eps=layer_norm_eps)
            else:
                blk = TransformerBlock(units, 4 * units, num_heads,
                                       dropout=dropout, causal=True,
                                       layer_norm_eps=layer_norm_eps)
            self.add_module(f"h{i}", blk)
            blocks.append(blk)
        self.blocks = blocks
        self.ln_f = LayerNorm(epsilon=layer_norm_eps, in_channels=units)

    def _logits(self, x):
        # tied LM head: logits = x · wteᵀ, the reference's FullyConnected
        return F.linear(*_amp.cast("FullyConnected", x, self.wte.weight))

    def forward(self, tokens):
        """Logits of ``tokens`` (B, T).  Under a mesh with ``sp`` above 1
        the tokens are this rank's sequence chunk, positions
        ``[i * T, (i + 1) * T)`` for the rank's ``sp`` index i."""
        t = tokens.shape[1]
        off = seq_offset(t)
        if off + t > self.max_length:
            raise ValueError(f"sequence length {off + t} exceeds "
                             f"max_length={self.max_length} (position "
                             "table size)")
        pos = torch.arange(off, off + t, dtype=torch.int32,
                           device=tokens.device)
        x = self.wte(tokens) + self.wpe(pos)[None]
        if self.drop is not None:
            x = self.drop(x)
        x = run_blocks(self.blocks, x, scan=self._scan_layers,
                       remat=self._remat)
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

    def init_cache(self, batch, max_length=None, dtype=None):
        """Per-layer dense KV caches {'k','v'} of (B, Tmax, H, D) zeros on
        the parameters' device; the dtype follows the parameters unless
        given.  :meth:`prefill` and :meth:`forward_step` write them in
        place."""
        _dense_blocks_only(self)
        t = max_length or self.max_length
        h, d = self.kv_heads()
        dev = self.wte.weight.device
        dt = self._cache_dtype() if dtype is None else torch_dtype(dtype)
        return [{"k": torch.zeros((batch, t, h, d), dtype=dt, device=dev),
                 "v": torch.zeros((batch, t, h, d), dtype=dt, device=dev)}
                for _ in self.blocks]

    @torch.no_grad()
    def prefill(self, tokens_nd, caches):
        """Batched cache fill over the prompt (B, Tp): one causal forward
        writes every layer's K/V for positions [0, Tp) and returns the
        last position's logits (B, vocab) and the caches."""
        tok, wrap = _tokens(tokens_nd, self.wte.weight.device)
        b, t = tok.shape
        pos = torch.arange(t, dtype=torch.int32, device=tok.device)
        x = self.wte(tok) + self.wpe(pos)[None]
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.forward_prefill(x, cache)
        x = self.ln_f(x[:, -1:])
        return wrap(self._logits(x).reshape(b, self.vocab_size)), caches

    @torch.no_grad()
    def forward_step(self, tok, caches, idx):
        """One decode position: tok (B, 1) int32 at position ``idx`` →
        (logits (B, vocab), caches).  Inference mode assumed."""
        tok, wrap = _tokens(tok, self.wte.weight.device)
        b = tok.shape[0]
        x = self.wte(tok) + self.wpe(torch.full_like(tok, int(idx)))
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.forward_step(x, cache, idx)
        x = self.ln_f(x)
        return wrap(self._logits(x).reshape(b, self.vocab_size)), caches

    def init_slot_cache(self, num_slots, max_length=None, dtype=None):
        """Persistent dense serving cache: per layer {'k','v'} of
        (num_slots, Tmax + 1, H, D) zeros on the parameters' device, in
        the parameters' dtype unless given; column Tmax is the trash
        column that out-of-range writes land in and nothing reads."""
        t = max_length or self.max_length
        h, d = self.kv_heads()
        dev = self.wte.weight.device
        dt = self._cache_dtype() if dtype is None else torch_dtype(dtype)
        return [{"k": torch.zeros((num_slots, t + 1, h, d), dtype=dt,
                                  device=dev),
                 "v": torch.zeros((num_slots, t + 1, h, d), dtype=dt,
                                  device=dev)}
                for _ in self.blocks]

    def init_page_cache(self, num_pages, page_size, dtype=None,
                        kv_quant=None):
        """Persistent paged serving cache.  ``num_pages`` counts the zero
        page, as in the reference (the engine passes its pool size + 1);
        one trash page is added past it, so each leaf holds
        ``num_pages + 1`` pages, in the parameters' dtype unless given.
        ``kv_quant='int8'`` stores int8 pages with float32
        per-position-per-head scales in ``k_scale``/``v_scale`` leaves of
        shape (N, ps, H, 1)."""
        h, d = self.kv_heads()
        dev = self.wte.weight.device
        n = num_pages + 1
        if kv_quant is None:
            dt = self._cache_dtype() if dtype is None else torch_dtype(dtype)
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
    def prefill_slots(self, tokens_nd, lens, caches, slot_idx, offset=None,
                      page_table=None, paged_kernel=False):
        """Admission prefill for a bucketed batch: tokens (B, Tb) int32
        right-padded, ``lens`` (B,) true lengths, ``slot_idx`` (B,) cache
        rows.  Writes every layer's K/V and returns the logits at each
        row's last real position (B, vocab) plus the (updated in place)
        caches.  ``offset`` (B,) makes row i a chunk at absolute
        positions [offset[i], offset[i] + Tb); ``page_table`` (S+1, P)
        selects the paged layout and ``paged_kernel`` its in-place read
        arm."""
        tokens = tokens_nd
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
    def verify_slots(self, tokens_nd, caches, pos, page_table=None,
                     paged_kernel=False):
        """Speculative verify forward: the decode step over an (S, W)
        window.  Row s consumes the window tokens at positions
        ``[pos[s], pos[s] + W)``, writes their K/V (parked rows at
        ``pos >= Tmax`` into the trash target), attends its whole cache
        row, and the logits of every window position come back,
        (S, W, vocab): ``logits[s, i]`` follows window token i.  Row i is
        slot i (``slot_idx=None``).  In the paged kernel arm each layer
        launches the paged-attention kernel with ``Tq = W``."""
        tokens = tokens_nd
        _dense_blocks_only(self)
        s, t = tokens.shape
        ar = torch.arange(t, dtype=torch.int32, device=tokens.device)
        # clamp the embedding lookup only: windows past Tmax write to the
        # trash target and their logits are never accepted
        apos = torch.clamp(pos[:, None] + ar[None], max=self.max_length - 1)
        x = self.wte(tokens) + self.wpe(apos)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.forward_prefill_slots(x, cache, None, pos,
                                             page_table, paged_kernel)
        return (self._logits(self.ln_f(x)).reshape(s, t, self.vocab_size),
                caches)

    @torch.no_grad()
    def draft_slots(self, tok, caches, pos, n_tokens, draft_layers,
                    temperature, top_k, top_p, seeds, poison=None,
                    page_table=None):
        """Self-speculative drafter: propose ``n_tokens`` tokens per slot
        by early exit after the first ``draft_layers`` blocks (then
        ``ln_f`` and the tied head); the caches' leading layers are its
        KV state.  Read-only on ``caches``: the speculated K/V live in
        per-layer window buffers (float32 under int8 pages).  Step i
        samples with the verifier's rule, keyed by (request seed,
        ``pos + i``), so a drafter that tracks the model proposes exactly
        the token the verifier draws.  One program, as the reference's
        compiled loop: positions, sampling rows and seeds are device
        tensors (``seeds`` may be a host sequence), nothing is read back
        to the host, and the ``n_tokens`` steps can be captured together
        in one CUDA graph.  ``poison`` (a float32 scalar tensor, 0.0
        unless a fault plan poisons it; None adds nothing) is added to
        the draft logits: the ``serving.draft_logits`` fault site rides
        it as a program input, so a plan's NaN reaches a replay of the
        graph captured clean.  Returns (S, n_tokens) int32."""
        from ..serving.sampling import sample_tokens
        _dense_blocks_only(self)
        if not 1 <= int(draft_layers) <= len(self.blocks):
            raise ValueError(f"draft_layers={draft_layers} must be in "
                             f"[1, {len(self.blocks)}]")
        blocks = self.blocks[:int(draft_layers)]
        s = tok.shape[0]
        h, d = self.kv_heads()
        dt = caches[0]["k"].dtype
        if not dt.is_floating_point:
            dt = torch.float32
        dev = tok.device
        seeds = torch.as_tensor(seeds, device=dev).to(torch.int64)
        wins = [(torch.zeros((s, n_tokens, h, d), dtype=dt, device=dev),
                 torch.zeros((s, n_tokens, h, d), dtype=dt, device=dev))
                for _ in blocks]
        rows = [blk.attn.cache_rows(cache, s, page_table)
                for blk, cache in zip(blocks, caches)]
        cur = tok.to(torch.int32)
        out = []
        for i in range(int(n_tokens)):
            p = torch.clamp(pos + i, max=self.max_length - 1)
            x = self.wte(cur.reshape(s, 1)) + self.wpe(p.reshape(s, 1))
            for blk, (wk, wv), r in zip(blocks, wins, rows):
                x = blk.forward_step_window(x, r, pos, wk, wv, i)
            lg = self._logits(self.ln_f(x)).reshape(s, self.vocab_size)
            if poison is not None:
                lg = lg + poison
            cur = sample_tokens(lg, temperature, top_k, top_p, seeds,
                                pos + i)
            out.append(cur)
        return torch.stack(out, dim=1)

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


def _tokens(tokens, device):
    """Token ids as an int32 tensor on ``device``, and the wrapper that
    hands results back in the caller's type (NDArray in, NDArray out)."""
    if isinstance(tokens, NDArray):
        return tokens.tensor.to(device, torch.int32), NDArray
    t = tokens if isinstance(tokens, torch.Tensor) else \
        torch.as_tensor(np.asarray(tokens))
    return t.to(device, torch.int32), (lambda x: x)


def gpt2_lm_loss(logits, labels, aux_weight=0.01):
    """Next-token cross entropy; ``labels`` (B, T) already shifted.  The
    mean over tokens of ``logsumexp(logits) - logits[label]`` in float32,
    as the reference computes it (``gpt2.py:525-539``) without a full
    log-softmax (float32 is also what the amp policy gives
    ``logsumexp``, so bf16 logits are widened here); labels clip to the
    vocabulary (``pick(mode='clip')``).  The router aux losses the
    forward recorded (MoE layers) are drained and added, each times
    ``aux_weight``; a dense model records none.  NDArray inputs give an
    NDArray, recorded inside ``autograd.record()``."""
    if isinstance(logits, NDArray) or isinstance(labels, NDArray):
        like = logits if isinstance(logits, NDArray) else labels
        return invoke("gpt2_lm_loss",
                      lambda x, y: gpt2_lm_loss(x, y, aux_weight),
                      [_as_nd(logits, like), _as_nd(labels, like)])
    x = logits.float()
    idx = labels.long().clamp(0, x.shape[-1] - 1)
    picked = x.gather(-1, idx[..., None])[..., 0]
    loss = (torch.logsumexp(x, dim=-1) - picked).mean()
    for aux in _base.pop_aux_losses():
        loss = loss + aux * aux_weight
    return loss


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
