"""Stacked-layer GPT-2 for pipeline parallelism (counterpart of
``mxnet_tpu/models/stacked.py``).

Every transformer layer's parameters live as one set of tensors with a
leading ``layers`` dim, annotated ``layers`` (→ ``pp`` in the default
rules).  On one stage the layers run in order, each under
``torch.utils.checkpoint`` when ``remat`` is on (the reference's
``jax.checkpoint`` inside its ``lax.scan``); each layer's attention is
``ops.attention.flash_attention``, so B1 runs forward (and again in the
recomputation) and B2/B3 backward on the card.  Under a mesh with ``pp``
above 1, ``parallel.shard_params`` keeps each rank's contiguous slice of
the stack (its stage) and the trunk runs through ``parallel.gpipe``.
Composes with ``dp`` (batch) and, through GPT-2's vocabulary-split
``wte`` (``gpt2.vocab_embed``/``vocab_logits``), ``tp``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as _ckpt

from .. import parallel as _par
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Embedding
from ..ops.attention import flash_attention
from ..parallel.sharding import annotate
from .gpt2 import vocab_embed, vocab_logits

__all__ = ["StackedGPT2Model", "get_stacked_gpt2"]

_NAMES = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_g", "ln2_b",
          "w1", "b1", "w2", "b2")


class StackedGPT2Model(HybridBlock):
    """Decoder-only LM with a stacked (pipelined) trunk.

    tokens (B, T) int32 → logits (B, T, vocab).  Weights are stacked
    (num_layers, ...) and annotated with the "layers" logical axis
    ("layers" → pp in the default sharding rules)."""

    def __init__(self, vocab_size=50257, units=768, num_layers=12,
                 num_heads=12, max_length=1024, layer_norm_eps=1e-5,
                 num_microbatches=None, remat=True, dtype="float32",
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units % num_heads != 0")
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._eps = layer_norm_eps
        self._num_microbatches = num_microbatches
        self._remat = remat
        self.wte = Embedding(vocab_size, units, dtype=dtype)
        annotate(self.wte.weight, "vocab", "embed")
        self.wpe = Embedding(max_length, units, dtype=dtype)
        annotate(self.wpe.weight, "seq", "embed")
        n, d, h4 = num_layers, units, 4 * units
        for name, shape, init in (
                ("ln1_g", (n, d), "ones"), ("ln1_b", (n, d), "zeros"),
                ("wqkv", (n, d, 3 * d), "xavier"),
                ("bqkv", (n, 3 * d), "zeros"),
                ("wo", (n, d, d), "xavier"), ("bo", (n, d), "zeros"),
                ("ln2_g", (n, d), "ones"), ("ln2_b", (n, d), "zeros"),
                ("w1", (n, d, h4), "xavier"), ("b1", (n, h4), "zeros"),
                ("w2", (n, h4, d), "xavier"), ("b2", (n, d), "zeros")):
            annotate(self._new_param(name, shape, dtype, init=init),
                     "layers", *(None,) * (len(shape) - 1))
        self.lnf_g = self._new_param("lnf_g", (d,), dtype, init="ones")
        self.lnf_b = self._new_param("lnf_b", (d,), dtype, init="zeros")

    @property
    def _stacked(self):
        return [getattr(self, n) for n in _NAMES]

    # ------------------------------------------------------------------
    def _layer(self, p, x):
        (l1g, l1b, wqkv, bqkv, wo, bo, l2g, l2b, w1, b1, w2, b2) = p
        bsz, t, d = x.shape
        h = self._num_heads
        hn = F.layer_norm(x, (d,), l1g, l1b, self._eps)
        q, k, v = torch.split(torch.matmul(hn, wqkv) + bqkv, d, dim=-1)
        # the flash kernels take contiguous (B, T, H, D) tensors
        q, k, v = (a.reshape(bsz, t, h, d // h).contiguous()
                   for a in (q, k, v))
        a = flash_attention(q, k, v, causal=True).reshape(bsz, t, d)
        x = x + torch.matmul(a, wo) + bo
        hn = F.layer_norm(x, (d,), l2g, l2b, self._eps)
        ff = F.gelu(torch.matmul(hn, w1) + b1, approximate="tanh")
        return x + torch.matmul(ff, w2) + b2

    def _run_layers(self, stack, x):
        """The layers of ``stack`` (each leaf (L', ...)) in order, each
        recomputed in backward under ``remat``."""
        for i in range(stack[0].shape[0]):
            p = [leaf[i] for leaf in stack]
            if self._remat and torch.is_grad_enabled():
                x = _ckpt.checkpoint(self._layer, p, x, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                x = self._layer(p, x)
        return x

    def microbatches(self, local_batch: int, pp: int) -> int:
        """The microbatch count for a stage's (B/|dp|)-row batch: the one
        asked for, else the largest of max(2·pp, 2) and below that
        divides it (the reference's default)."""
        if self._num_microbatches is not None:
            return self._num_microbatches
        m = max(2 * pp, 2)
        while local_batch % m:
            m -= 1
        return m

    def forward(self, tokens):
        mesh = _par.current_mesh()
        pp = _par.axis_size(mesh, "pp") if mesh is not None else 1
        if self._num_layers % max(pp, 1):
            raise ValueError(f"{self._num_layers} layers not divisible by "
                             f"pp={pp}")
        if mesh is not None and _par.axis_size(mesh, "sp") > 1:
            raise MXNetError(
                "the stacked GPT-2 under sp: its layers attend over the "
                "rank's chunk only; sequence parallelism runs in GPT2Model")
        t = tokens.shape[1]
        pos = torch.arange(t, dtype=torch.int32, device=tokens.device)
        x = vocab_embed(self.wte, tokens) + self.wpe(pos)[None]
        stack = self._stacked
        if pp > 1:
            from ..parallel.pipeline import gpipe
            # the stages of the whole stack, or this rank's stage (its
            # (L/pp, ...) block after shard_params), stage leading
            stages = tuple(s.reshape(pp, -1, *s.shape[1:])
                           if s.shape[0] == self._num_layers else s[None]
                           for s in stack)
            x = gpipe(self._run_layers, stages, x,
                      num_microbatches=self.microbatches(x.shape[0], pp),
                      mesh=mesh)
        else:
            x = self._run_layers(stack, x)
        x = F.layer_norm(x, (self._units,), self.lnf_g, self.lnf_b,
                         self._eps)
        return vocab_logits(self.wte.weight, x)


def get_stacked_gpt2(name="gpt2_124m", device=None, **kwargs):
    """A stacked GPT-2 of a published size, fields overridable by
    ``kwargs``, to be initialized on ``device`` (default: the current
    CUDA device; raises without one — pass ``device='cpu'`` for the
    CPU)."""
    from .gpt2 import _CONFIGS
    dev = resolve_device(device)
    layers, units, heads = _CONFIGS[name]
    cfg = dict(units=units, num_layers=layers, num_heads=heads)
    cfg.update(kwargs)
    net = StackedGPT2Model(**cfg)
    net._device = dev
    return net
