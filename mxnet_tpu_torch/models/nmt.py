"""Sockeye-style Transformer NMT (counterpart of
``mxnet_tpu/models/nmt.py``; BASELINE config 4, Transformer-big WMT
En-De).

An encoder of :class:`~.transformer.TransformerEncoderLayer` and a
decoder of :class:`TransformerDecoderBlock` (causal self-attention,
cross-attention to the encoder's output, FFN), sinusoidal positions,
the output projection tied to the target embedding, and label-smoothed
cross entropy.  On the card the flash kernels take the encoder's
self-attention (non-causal), the decoder's (causal) and the
cross-attention when source and target lengths are equal and no source
mask is given; otherwise attention takes the reference path, as in the
reference.  The reference's sharding annotations and ``_mesh_put``
have no counterpart on one device.  ``translate`` is greedy or
length-normalized beam search; like the reference's it re-decodes the
whole prefix at each step.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import amp as _amp
from .. import base as _base
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dropout, Embedding, LayerNorm
from ..ndarray.ops import apply_op
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoderLayer, _remat_layer, run_blocks,
                          seq_offset)

__all__ = ["TransformerDecoderBlock", "TransformerNMT", "nmt_loss",
           "get_nmt"]

_CONFIGS = {
    # name: (layers, units, hidden, heads)
    "transformer_base": (6, 512, 2048, 8),
    "transformer_big": (6, 1024, 4096, 16),
}


def _sinusoidal_positions(x, units):
    """``x`` (B, T, U) plus the sinusoidal position encoding (sin over
    the first U/2 lanes, cos over the rest; no learned table)."""
    t = x.shape[1]
    off = seq_offset(t)       # this rank's chunk under an sp mesh
    pos = torch.arange(off, off + t, dtype=torch.float32,
                       device=x.device)[:, None]
    dim = torch.arange(units // 2, dtype=torch.float32,
                       device=x.device)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * dim / units)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return x + pe[None].to(x.dtype)


class TransformerDecoderBlock(HybridBlock):
    """Pre-LN decoder layer: causal self-attention → cross-attention to
    the encoder's output → FFN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, layer_norm_eps=1e-5):
        super().__init__()
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.self_attn = MultiHeadAttention(
            units, num_heads, dropout=dropout,
            attention_dropout=attention_dropout, causal=True)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.cross_attn = MultiHeadAttention(
            units, num_heads, dropout=dropout,
            attention_dropout=attention_dropout, causal=False)
        self.ln3 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout)

    def forward(self, x, memory, mem_mask=None):
        x = x + self.self_attn(self.ln1(x))
        x = x + self.cross_attn(self.ln2(x), mem_mask, memory)
        return x + self.ffn(self.ln3(x))


class TransformerNMT(HybridBlock):
    """Encoder-decoder transformer: (src, tgt) int32 token batches →
    logits (B, T_tgt, tgt_vocab).  ``tgt`` is the shifted-right target
    (BOS first); the labels are the unshifted target."""

    def __init__(self, src_vocab_size, tgt_vocab_size=None, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8, dropout=0.1,
                 layer_norm_eps=1e-5, shared_embed=False, scan_layers=None,
                 remat=False):
        super().__init__()
        tgt_vocab_size = tgt_vocab_size or src_vocab_size
        self._units = units
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self._scan_layers = scan_layers
        self._remat = remat
        self.src_embed = Embedding(src_vocab_size, units)
        if shared_embed:
            if tgt_vocab_size != src_vocab_size:
                raise ValueError("shared_embed needs equal vocab sizes")
            self.tgt_embed = self.src_embed
        else:
            self.tgt_embed = Embedding(tgt_vocab_size, units)
        self.drop = Dropout(dropout) if dropout else None
        self.enc_layers = self._stack("enc", num_layers, lambda: (
            TransformerEncoderLayer(units, hidden_size, num_heads,
                                    dropout=dropout,
                                    layer_norm_eps=layer_norm_eps)))
        self.enc_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.dec_layers = self._stack("dec", num_layers, lambda: (
            TransformerDecoderBlock(units, hidden_size, num_heads,
                                    dropout=dropout,
                                    layer_norm_eps=layer_norm_eps)))
        self.dec_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units)

    def _stack(self, name, n, make):
        layers = []
        for i in range(n):
            layers.append(self.register_child(make(), f"{name}{i}"))
        return layers

    # ------------------------------------------------------------------
    @staticmethod
    def _src_mask(src, src_valid_length):
        """(B, 1, 1, T_src) key mask of the real source positions, or
        None."""
        if src_valid_length is None:
            return None
        b, ts = src.shape
        steps = torch.arange(ts, device=src.device)
        return steps.reshape(1, 1, 1, ts) < \
            torch.as_tensor(src_valid_length, device=src.device) \
            .reshape(b, 1, 1, 1)

    def _embed(self, embed, tokens):
        x = _sinusoidal_positions(embed(tokens) * math.sqrt(self._units),
                                  self._units)
        return self.drop(x) if self.drop is not None else x

    def encode(self, src, src_valid_length=None):
        x = self._embed(self.src_embed, src)
        x = run_blocks(self.enc_layers, x, self._src_mask(
            src, src_valid_length), scan=self._scan_layers,
            remat=self._remat)
        return self.enc_ln(x)

    def decode(self, tgt, memory, src=None, src_valid_length=None):
        y = self._embed(self.tgt_embed, tgt)
        mem_mask = (self._src_mask(src, src_valid_length)
                    if src is not None else None)
        remat = self._remat and torch.is_grad_enabled()
        for blk in self.dec_layers:
            # under remat ``memory`` is a checkpoint input: saved, not
            # recomputed, its gradient summed over the layers
            y = _remat_layer(blk, y, mem_mask, self._remat, memory) \
                if remat else blk(y, memory, mem_mask)
        y = self.dec_ln(y)
        # tied output projection: logits = y · tgt_embedᵀ
        return F.linear(*_amp.cast("FullyConnected", y,
                                   self.tgt_embed.weight))

    def forward(self, src, tgt, src_valid_length=None):
        memory = self.encode(src, src_valid_length)
        return self.decode(tgt, memory, src, src_valid_length)

    # ------------------------------------------------------- inference
    def _inputs(self, src, src_valid_length):
        dev = self.src_embed.weight.device
        src = torch.as_tensor(np.asarray(src) if not isinstance(
            src, torch.Tensor) else src, device=dev).to(torch.int32)
        if src_valid_length is not None:
            src_valid_length = torch.as_tensor(
                np.asarray(src_valid_length) if not isinstance(
                    src_valid_length, torch.Tensor) else src_valid_length,
                device=dev).to(torch.int32)
        return src, src_valid_length

    @torch.no_grad()
    def translate(self, src, src_valid_length=None, max_length=32,
                  bos_id=1, eos_id=2, beam_size=1, alpha=1.0):
        """Greedy (``beam_size=1``) or length-normalized beam decode
        (``alpha`` is the length-penalty exponent).  ``src`` (B, T)
        int32 (tensor or numpy).  Returns (B, <= max_length) int32 numpy
        tokens, padded with EOS."""
        src, vlen = self._inputs(src, src_valid_length)
        if beam_size > 1:
            return self._beam_translate(src, vlen, max_length, bos_id,
                                        eos_id, beam_size, alpha)
        with _base.training_mode(False):
            memory = self.encode(src, vlen)
            b = src.shape[0]
            tokens = np.full((b, 1), bos_id, dtype=np.int32)
            done = np.zeros((b,), dtype=bool)
            for _ in range(max_length):
                logits = self.decode(torch.from_numpy(tokens).to(src.device),
                                     memory, src, vlen)
                nxt = logits[:, -1].argmax(-1).cpu().numpy().astype(np.int32)
                nxt = np.where(done, eos_id, nxt)
                done |= nxt == eos_id
                tokens = np.concatenate([tokens, nxt[:, None]], axis=1)
                if done.all():
                    break
            return tokens[:, 1:]

    def _beam_translate(self, src, vlen, max_length, bos_id, eos_id, k,
                        alpha):
        """Beam search of width ``k`` with scores in float64 on the host,
        as the reference keeps them: a beam that ends is offered to the
        row's finished pool the step it ends (so a later, higher-scoring
        live beam cannot evict it before length normalization); rows
        with no finished beam take their best live one."""
        b = src.shape[0]
        src_rep = src.repeat_interleave(k, dim=0)
        vlen_rep = None if vlen is None else vlen.repeat_interleave(k, 0)
        best_norm = np.full((b,), -np.inf, dtype=np.float64)
        best_tokens = [None] * b

        def offer(row, toks, score):
            n = score / (max(len(toks) - 1, 1) ** alpha)
            if n > best_norm[row]:
                best_norm[row] = n
                best_tokens[row] = toks.copy()

        with _base.training_mode(False):
            # each source encoded once; its k beams share the rows
            memory = self.encode(src, vlen).repeat_interleave(k, dim=0)
            tokens = np.full((b * k, 1), bos_id, dtype=np.int32)
            scores = np.full((b, k), -1e30, dtype=np.float64)
            scores[:, 0] = 0.0          # all beams start identical: keep 1
            done = np.zeros((b * k,), dtype=bool)
            for _ in range(max_length):
                logits = self.decode(torch.from_numpy(tokens).to(src.device),
                                     memory, src_rep, vlen_rep)
                step = logits[:, -1].cpu().numpy().astype(np.float64)
                mx = step.max(-1, keepdims=True)
                logp = step - np.log(np.exp(step - mx).sum(-1,
                                                           keepdims=True)) \
                    - mx
                vocab = logp.shape[-1]
                # finished beams only extend with EOS at zero cost
                logp[done] = -1e30
                logp[done, eos_id] = 0.0
                cand = (scores.reshape(b * k, 1) + logp).reshape(b,
                                                                 k * vocab)
                top = np.argpartition(-cand, k - 1, axis=1)[:, :k]
                top_scores = np.take_along_axis(cand, top, axis=1)
                order = np.argsort(-top_scores, axis=1)
                top = np.take_along_axis(top, order, axis=1)
                scores = np.take_along_axis(top_scores, order, axis=1)
                flat = (np.arange(b)[:, None] * k + top // vocab).reshape(-1)
                was_done = done[flat]
                tokens = np.concatenate(
                    [tokens[flat],
                     (top % vocab).astype(np.int32).reshape(-1, 1)], axis=1)
                done = was_done | (tokens[:, -1] == eos_id)
                for i in np.nonzero(done & ~was_done)[0]:
                    offer(i // k, tokens[i], scores.reshape(-1)[i])
                if done.all():
                    break
            # unfinished rows: the best live beam, length-normalized
            # (Sockeye's lp: len^alpha)
            lengths = (tokens[:, 1:] != eos_id).sum(1) + 1.0
            norm = scores.reshape(-1) / (lengths ** alpha)
            live_best = norm.reshape(b, k).argmax(1)
            out = np.full((b, tokens.shape[1] - 1), eos_id, dtype=np.int32)
            for row in range(b):
                hyp = (tokens.reshape(b, k, -1)[row, live_best[row], 1:]
                       if best_tokens[row] is None
                       else best_tokens[row][1:])
                out[row, :len(hyp)] = hyp
            return out


def nmt_loss(logits, labels, valid_length=None, label_smoothing=0.1):
    """Label-smoothed cross entropy, the mean over the positions before
    each row's ``valid_length`` (every position without it):
    ``(1 - eps) · (lse - logit[label]) + eps · (lse - mean(logits))``
    (Sockeye's training loss, eps = 0.1).  Labels clip to the
    vocabulary."""
    def f(x, y, *vl):
        x = x.float()
        lse = torch.logsumexp(x, dim=-1)
        idx = y.long().clamp(0, x.shape[-1] - 1)[..., None]
        nll = (1.0 - label_smoothing) * (lse - x.gather(-1, idx)[..., 0]) \
            + label_smoothing * (lse - x.mean(dim=-1))
        if not vl:
            return nll.mean()
        b, t = y.shape
        m = (torch.arange(t, device=y.device)[None, :] <
             vl[0].reshape(b, 1)).float()
        return (nll * m).sum() / m.sum()
    ins = [logits, labels] + ([] if valid_length is None else
                              [valid_length])
    return apply_op("nmt_loss", f, ins)


def get_nmt(name="transformer_base", device=None, **kwargs):
    """A :class:`TransformerNMT` of a published size
    (``transformer_base``, ``transformer_big``), fields overridable by
    ``kwargs`` (``src_vocab_size`` is required), to be initialized on
    ``device`` (default: the current CUDA device; ``'cpu'`` for the
    CPU)."""
    dev = resolve_device(device)
    layers, units, hidden, heads = _CONFIGS[name]
    cfg = dict(units=units, hidden_size=hidden, num_layers=layers,
               num_heads=heads)
    cfg.update(kwargs)
    net = TransformerNMT(**cfg)
    net._device = dev
    return net
