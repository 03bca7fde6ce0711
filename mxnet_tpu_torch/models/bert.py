"""BERT encoder and its pretraining heads (counterpart of
``mxnet_tpu/models/bert.py``; parity target GluonNLP's BERT).

Tokens (B, T) and token types go through word, position and type
embeddings, LayerNorm and dropout, then the stack of
:class:`~.transformer.TransformerEncoderLayer` (bidirectional
attention: the flash kernels on the card at T >= 256 with no mask).
``valid_length`` (B,) makes a (B, 1, 1, T) key mask, which sends
attention to the reference path.  :class:`BERTForPretrain` adds the
masked-LM head, tied to ``word_embed.weight`` (its gradient sums both
uses), and the next-sentence head.

Over a mesh (``parallel.shard_params``, ``ShardedTrainer(mesh=...)``):
under ``tp`` the layers split as ``transformer.py`` says, and
``word_embed`` by vocabulary (``gpt2.vocab_embed``); the masked-LM head
computes this rank's block of the logits (``gpt2.vocab_logits``) and
all-gathers it over ``tp``, so the logits BERT returns are the whole
vocabulary, which any loss written with ``nd`` ops can take (at most
B x M x V floats a step); the gather's backward keeps this rank's
columns.  Position and type embeddings, the pooler and the heads are
replicated.  Under ``sp`` each rank holds a chunk of the sequence: the
key mask of ``valid_length`` is built at the chunk's global positions
and gathered with the keys (``transformer.py``), and the pooler's first
token and the masked positions are picked from the chunks that hold
them and summed over ``sp`` (``collectives.psum``).
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ndarray.ops import apply_op
from ..parallel import collectives as _coll
from ..parallel.sharding import annotate, gather_vocab
from .gpt2 import vocab_embed, vocab_logits
from .transformer import (TransformerEncoderLayer, _sp_mesh, run_blocks,
                          seq_first, seq_offset)

__all__ = ["BERTModel", "BERTForPretrain", "get_bert"]

_CONFIGS = {
    # name: (layers, units, heads)
    "bert_base": (12, 768, 12),
    "bert_large": (24, 1024, 16),
}


class BERTModel(HybridBlock):
    """tokens (B, T), token_types (B, T) → sequence output (B, T, units),
    pooled output (B, units)."""

    def __init__(self, vocab_size=30522, units=768, num_layers=12,
                 num_heads=12, max_length=512, type_vocab_size=2,
                 dropout=0.1, layer_norm_eps=1e-12, scan_layers=None,
                 remat=False):
        super().__init__()
        self._scan_layers = scan_layers
        self._remat = remat
        self._units = units
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.word_embed = Embedding(vocab_size, units)
        annotate(self.word_embed.weight, "vocab", "embed")
        self.token_type_embed = Embedding(type_vocab_size, units)
        self.position_embed = Embedding(max_length, units)
        annotate(self.position_embed.weight, "seq", "embed")
        self.embed_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.embed_drop = Dropout(dropout) if dropout else None
        layers = []
        for i in range(num_layers):
            layer = TransformerEncoderLayer(units, 4 * units, num_heads,
                                            dropout=dropout,
                                            layer_norm_eps=layer_norm_eps)
            self.register_child(layer, f"layer{i}")
            layers.append(layer)
        self.layers = layers
        self.pooler = Dense(units, activation="tanh", flatten=False,
                            in_units=units)

    def forward(self, tokens, token_types=None, valid_length=None):
        b, t = tokens.shape
        if t > self.max_length:
            raise ValueError(f"sequence length {t} exceeds max_length="
                             f"{self.max_length} (position table size)")
        # positions of this rank's chunk under an sp mesh
        steps = torch.arange(t, dtype=torch.int32, device=tokens.device) \
            + seq_offset(t)
        x = vocab_embed(self.word_embed, tokens) + \
            self.position_embed(steps)[None]
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_ln(x)
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        mask = None
        if valid_length is not None:
            # (B, 1, 1, T) key-side padding mask
            mask = steps.reshape(1, 1, 1, t) < \
                valid_length.to(steps.device).reshape(b, 1, 1, 1)
        x = run_blocks(self.layers, x, mask, scan=self._scan_layers,
                       remat=self._remat)
        return x, self.pooler(seq_first(x))


class BERTForPretrain(HybridBlock):
    """Masked-LM and next-sentence heads over a :class:`BERTModel`
    (GluonNLP's ``BERTForPretrain``)."""

    def __init__(self, backbone: BERTModel):
        super().__init__()
        self._device = backbone._device
        self.backbone = backbone
        units = backbone._units
        self.mlm_dense = Dense(units, activation="gelu", flatten=False,
                               in_units=units)
        self.mlm_ln = LayerNorm(in_channels=units)
        self.nsp = Dense(2, flatten=False, in_units=units)

    def forward(self, tokens, token_types=None, valid_length=None,
                masked_positions=None):
        seq, pooled = self.backbone(tokens, token_types, valid_length)
        if masked_positions is not None:
            seq = _gather_positions(seq, masked_positions)
        h = self.mlm_ln(self.mlm_dense(seq))
        # tied to the word embedding: logits = h · word_embedᵀ, the
        # vocabulary whole (a block under tp, gathered)
        mlm_logits = gather_vocab(vocab_logits(
            self.backbone.word_embed.weight, h))
        return mlm_logits, self.nsp(pooled)


def _gather_positions(seq, positions):
    """(B, T, U) gathered at (B, M) per-row positions → (B, M, U).  Under
    ``sp`` ``seq`` is this rank's chunk and the positions are global: each
    rank picks those inside its chunk (zeros elsewhere) and the picks are
    summed over ``sp``."""
    mesh = _sp_mesh()

    def f(x, pos):
        pos = pos.long()
        if mesh is not None:
            t = x.shape[1]
            pos = pos - mesh.axis_index("sp") * t
            inside = (pos >= 0) & (pos < t)
            pos = pos.clamp(0, t - 1)
        idx = pos[:, :, None].expand(-1, -1, x.shape[-1])
        out = torch.gather(x, 1, idx)
        if mesh is None:
            return out
        out = out * inside[..., None].to(out.dtype)
        return _coll.psum(out, mesh.group("sp"))
    return apply_op("gather_positions", f, [seq, positions])


def get_bert(name="bert_base", device=None, **kwargs):
    """A :class:`BERTModel` of a published size (``bert_base``,
    ``bert_large``), fields overridable by ``kwargs``, to be initialized
    on ``device`` (default: the current CUDA device; ``'cpu'`` for the
    CPU)."""
    dev = resolve_device(device)
    layers, units, heads = _CONFIGS[name]
    cfg = dict(units=units, num_layers=layers, num_heads=heads)
    cfg.update(kwargs)
    net = BERTModel(**cfg)
    net._device = dev
    return net
