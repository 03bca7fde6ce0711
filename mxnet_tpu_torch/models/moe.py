"""Mixture-of-Experts layers on one device (counterpart of
``mxnet_tpu/models/moe.py``).

The layer computes exactly the reference's GShard routing (``_moe_ffn``,
``moe.py:53-95``): a float32 router, softmax, ``top_k``, the top-k gates
renormalized; each choice ``j`` takes the next free position of its
expert by a cumulative sum over the flattened (b, t) tokens, with the
counts carried from choice ``j`` to ``j + 1``; a choice at a position
``>= capacity`` is dropped, and so is a kept choice whose gate is 0
(the reference's ``dispatch = combine > 0``); GELU (jax's default tanh
form) experts with biases; the load-balance loss ``E · Σ_e frac_top1 ·
mean_prob``.

It dispatches by index where the reference multiplies one-hot tensors:
every kept (token, choice) writes its row into an (E·C, D) buffer, the
experts run as ``torch.bmm`` over (E, C, ·), and the combine gathers each
choice's row back and weights it by its gate.  The reference's (N, E,
C) dispatch and combine tensors would be 16384 × 8 × 5120 floats each per
MoE layer at GPT-2 124M's training shape.  Positions are integers and the
kept set is the reference's, so outputs agree to float32 rounding.
Every shape is fixed by (N, E, C): dropped choices land in a trash row
past the buffer, so routing never reads a count back to the host.

Router aux losses are recorded into the ambient collector of
:mod:`mxnet_tpu_torch.base` while ``autograd.record()`` or an
aux-collection scope is open (``ShardedTrainer`` opens one per
(micro)batch); the loss drains them (:func:`pop_aux_losses`).  Expert
parallelism (the reference's ``ep`` mesh axis) is ROADMAP queue A6.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp as _amp
from .. import base as _base
from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..gluon.nn import Dropout, LayerNorm
from ..ndarray.ops import apply_op
from ..ops import dots as _dots

__all__ = ["MoELayer", "MoETransformerBlock", "moe_ffn", "pop_aux_losses",
           "aux_loss_scope"]

_ACTIVATIONS = {"gelu": lambda h: F.gelu(h, approximate="tanh"),
                "relu": F.relu, "silu": F.silu}


def pop_aux_losses():
    """Drain and return the aux losses recorded since the last pop (0-d
    tensors; empty if no MoE layer recorded)."""
    return _base.pop_aux_losses()


class aux_loss_scope:
    """A clean aux-loss slate: drains the collector on entry and exit.
    It also opens an aux-collection scope, so MoE layers called on
    tensors (outside ``autograd.record()``) record for a loss computed
    inside it; the reference needs no such scope for its eager layers."""

    def __enter__(self):
        _base.pop_aux_losses()
        self._prev = _base.set_aux_collection(True)
        return self

    def __exit__(self, *a):
        _base.set_aux_collection(self._prev)
        _base.pop_aux_losses()


def _route(xf, wg, num_experts, top_k, capacity):
    """The router on (N, D) tokens: (probs (N, E) float32, gates (N, k)
    renormalized, expert ids (N, k), positions (N, k) within the expert,
    in capacity (N, k) bool)."""
    probs = torch.softmax(_dots.matmul(xf.float(), wg.float().t()), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # the one-hot is laid out (E, N), so the cumulative sum runs along
    # the inner dimension: over (N, E) it is a scan of 8 long columns
    experts = torch.arange(num_experts, device=xf.device)[:, None]
    counts = torch.zeros((num_experts, 1), dtype=torch.int64,
                         device=xf.device)
    pos = []
    for j in range(top_k):
        m = (idx[None, :, j] == experts).long()               # (E, N)
        pos.append((torch.cumsum(m, 1) - 1 + counts)
                   .gather(0, idx[None, :, j])[0])
        counts = counts + m.sum(1, keepdim=True)
    pos = torch.stack(pos, dim=1)
    return probs, gates, idx, pos, pos < capacity


def _moe_ffn(x, wg, w1, b1, w2, b2, *, num_experts, top_k, capacity,
             activation="gelu"):
    """x (B, T, D) → (y (B, T, D), aux, dropped): ``dropped`` is the share
    of (token, choice) assignments no expert took (a 0-d tensor)."""
    b, t, d = x.shape
    e, c, n = num_experts, capacity, b * t
    xf = x.reshape(n, d)
    probs, gates, idx, pos, in_cap = _route(xf, wg, e, top_k, c)
    slot = idx * c + pos
    trash = torch.full_like(slot, e * c)
    dispatched = in_cap & (gates > 0)
    rows = xf[:, None, :].expand(n, top_k, d).reshape(n * top_k, d)
    x_e = xf.new_zeros((e * c + 1, d)).index_copy(
        0, torch.where(dispatched, slot, trash).reshape(-1), rows)
    x_e = x_e[:e * c].reshape(e, c, d)
    h = _dots.matmul(x_e, w1) + b1[:, None, :]
    h = _ACTIVATIONS[activation](h).to(xf.dtype)
    y_e = (_dots.matmul(h, w2) + b2[:, None, :]).float()
    y_e = torch.cat([y_e.reshape(e * c, d), y_e.new_zeros((1, d))])
    picked = y_e.index_select(
        0, torch.where(in_cap, slot, trash).reshape(-1)).reshape(n, top_k, d)
    y = (picked * (gates * in_cap)[..., None]).sum(dim=1)
    frac = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    dropped = 1.0 - dispatched.float().mean()
    return y.reshape(b, t, d).to(x.dtype), aux, dropped


def moe_ffn(x, gate, w1, b1, w2, b2, *, num_experts, top_k, capacity,
            activation="gelu"):
    """The routed expert FFN as an op (the reference's ``moe_ffn``):
    ``(y, aux)`` for tensors, or NDArrays through ``invoke``."""
    def fn(*args):
        y, aux, _dropped = _moe_ffn(
            *args, num_experts=num_experts, top_k=top_k, capacity=capacity,
            activation=activation)
        return y, aux
    return apply_op("moe_ffn", fn, [x, gate, w1, b1, w2, b2])


class MoELayer(HybridBlock):
    """Top-k routed expert FFN (drop-in for ``PositionwiseFFN``), with the
    reference's parameters: ``gate`` (E, units), ``w1`` (E, units,
    hidden), ``b1`` (E, hidden), ``w2`` (E, hidden, units), ``b2`` (E,
    units).  After each call ``last_aux`` and ``last_dropped`` hold that
    call's aux loss and dropped share (detached, on the device)."""

    def __init__(self, units, hidden_size, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu", dropout=0.0,
                 dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if activation not in _ACTIVATIONS:
            raise MXNetError(f"activation {activation!r}: expected one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.dropout = Dropout(dropout) if dropout else None
        self._units = units
        self._hidden = hidden_size
        self._num_experts = num_experts
        self._top_k = min(top_k, num_experts)
        self._capacity_factor = capacity_factor
        self._act_name = activation
        for name, shape, init in (
                ("gate", (num_experts, units), "xavier"),
                ("w1", (num_experts, units, hidden_size), "xavier"),
                ("b1", (num_experts, hidden_size), "zeros"),
                ("w2", (num_experts, hidden_size, units), "xavier"),
                ("b2", (num_experts, units), "zeros")):
            self._new_param(name, shape, dtype, init=init)
        self.last_aux = self.last_dropped = None

    def capacity(self, n_tokens: int) -> int:
        cap = int(math.ceil(self._top_k * n_tokens / self._num_experts
                            * self._capacity_factor))
        return max(cap, self._top_k)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        y, aux, dropped = _moe_ffn(
            *_amp.cast("moe_ffn", x, self.gate, self.w1, self.b1, self.w2,
                       self.b2),
            num_experts=self._num_experts, top_k=self._top_k,
            capacity=self.capacity(b * t), activation=self._act_name)
        # recorded only where a loss of the same (micro)batch drains it
        if _base.is_recording() or _base.aux_collection_active():
            _base.record_aux_loss(aux)
        self.last_aux, self.last_dropped = aux.detach(), dropped
        if self.dropout is not None:
            y = self.dropout(y)
        return y


class MoETransformerBlock(HybridBlock):
    """Pre-LN transformer layer whose FFN is a routed MoE."""

    def __init__(self, units, hidden_size, num_heads, num_experts,
                 top_k=2, capacity_factor=1.25, dropout=0.0,
                 attention_dropout=0.0, causal=True, layer_norm_eps=1e-5,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        from .transformer import MultiHeadAttention
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.attn = MultiHeadAttention(
            units, num_heads, dropout=dropout,
            attention_dropout=attention_dropout, causal=causal)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.moe = MoELayer(units, hidden_size, num_experts, top_k=top_k,
                            capacity_factor=capacity_factor,
                            dropout=dropout)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.moe(self.ln2(x))
