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
(micro)batch); the loss drains them (:func:`pop_aux_losses`).

**Over a mesh.**  The parameters carry the reference's annotations
(``w1`` (expert, embed, mlp), ``b1`` (expert, mlp), ``w2`` (expert, mlp,
embed), ``b2`` (expert, embed), ``gate`` replicated), so after
``parallel.shard_params`` each rank holds E/ep experts and, of ``w1``,
``b1`` and ``w2``, the hidden units of its ``tp`` index.  The routing is
the reference's global one, which GSPMD computes over the whole batch:
under ``dp`` (and ``sp``) each rank routes its own tokens, the expert
choices are gathered over the data axes (N·k integers a layer), and the
capacity, every choice's position, the top-1 fractions and the dropped
share are taken over the global batch; the mean router probability is a
sum over the data axes whose backward sums too, so the aux loss is the
global one.  The tokens are the same on every rank of an ``ep`` and
``tp`` line: each rank runs its experts on the choices routed to them
(entered through ``collectives.copy_to``), weights them by their gates,
and one sum over (ep, tp) completes the layer (``collectives.
reduce_from``).  ``b2`` is added by the first ``tp`` rank of each
expert, and its gradient reaches every ``tp`` rank.
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
from ..parallel import collectives as _coll
from ..parallel.mesh import axis_size, current_mesh
from ..parallel.sharding import DATA_AXES, annotate, block_mesh

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


def _gates(xf, wg, top_k):
    """The float32 router on (N, D) tokens: (probs (N, E), gates (N, k)
    renormalized, expert ids (N, k))."""
    probs = torch.softmax(_dots.matmul(xf.float(), wg.float().t()), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    return probs, gates / gates.sum(dim=-1, keepdim=True), idx


def _route(xf, wg, num_experts, top_k, capacity):
    """The router on (N, D) tokens of one batch: (probs (N, E) float32,
    gates (N, k) renormalized, expert ids (N, k), positions (N, k) within
    the expert, in capacity (N, k) bool)."""
    probs, gates, idx = _gates(xf, wg, top_k)
    pos = _positions(idx, num_experts)
    return probs, gates, idx, pos, pos < capacity


def _positions(idx, num_experts):
    """Each choice's position within its expert, (N, k) int64, from the
    expert ids ``idx`` (N, k) in token order: a cumulative sum over the
    tokens, the counts carried from choice j to j + 1."""
    # the one-hot is laid out (E, N), so the cumulative sum runs along
    # the inner dimension: over (N, E) it is a scan of 8 long columns
    experts = torch.arange(num_experts, device=idx.device)[:, None]
    counts = torch.zeros((num_experts, 1), dtype=torch.int64,
                         device=idx.device)
    pos = []
    for j in range(idx.shape[1]):
        m = (idx[None, :, j] == experts).long()               # (E, N)
        pos.append((torch.cumsum(m, 1) - 1 + counts)
                   .gather(0, idx[None, :, j])[0])
        counts = counts + m.sum(1, keepdim=True)
    return torch.stack(pos, dim=1)


class _Split:
    """Where a layer's tokens and experts live over the current mesh:
    ``data`` the group over the data axes (None: this rank holds the
    whole batch); ``group`` the (ep, tp) group of its expert blocks
    (None: whole experts), ``e0`` its first expert, ``tp0`` whether it
    adds ``b2``."""

    def __init__(self, layer):
        mesh = current_mesh()
        self.mesh = mesh
        self.data = None
        if mesh is not None and any(axis_size(mesh, a) > 1
                                    for a in DATA_AXES):
            self.data = mesh.group(DATA_AXES)
        ep = block_mesh(layer.w1, "ep")
        tp = block_mesh(layer.w1, "tp")
        split = ep or tp
        self.group = split.group(("ep", "tp")) if split else None
        self.e0 = ep.axis_index("ep") * layer.w1.shape[0] if ep else 0
        self.tp0 = tp is None or tp.axis_index("tp") == 0

    @property
    def ranks(self) -> int:
        """Ranks the global batch is split over."""
        return 1 if self.data is None else \
            torch.distributed.get_world_size(self.data)

    def global_idx(self, idx, b, t):
        """The expert choices (B·T, k) of the global batch, in its token
        order, from every data rank's (b·t, k)."""
        import torch.distributed as dist
        k = idx.shape[1]
        parts = _coll.all_gather(idx.reshape(b, t, k), self.data)
        dp, sp = axis_size(self.mesh, "dp"), axis_size(self.mesh, "sp")
        out = idx.new_empty((dp * b, sp * t, k))
        for i, part in enumerate(parts):
            c = self.mesh.coords(dist.get_global_rank(self.data, i))
            out[c["dp"] * b:(c["dp"] + 1) * b,
                c["sp"] * t:(c["sp"] + 1) * t] = part
        return out.reshape(-1, k)

    def local_rows(self, a, b, t):
        """This rank's tokens of a global (B·T, ...) array."""
        c = self.mesh.coords()
        g = a.reshape(axis_size(self.mesh, "dp") * b,
                      axis_size(self.mesh, "sp") * t, *a.shape[1:])
        return g[c["dp"] * b:(c["dp"] + 1) * b,
                 c["sp"] * t:(c["sp"] + 1) * t].reshape(b * t,
                                                        *a.shape[1:])


def _moe_ffn(x, wg, w1, b1, w2, b2, *, num_experts, top_k, capacity,
             activation="gelu", split=None):
    """x (B, T, D) → (y (B, T, D), aux, dropped): ``dropped`` is the share
    of (token, choice) assignments no expert took (a 0-d tensor).
    ``split`` (a :class:`_Split`) runs the layer over a mesh: ``x`` is
    this rank's block of the batch, ``capacity`` the global batch's and
    ``w1``-``b2`` this rank's expert blocks."""
    b, t, d = x.shape
    e, c, n = num_experts, capacity, b * t
    data = split.data if split is not None else None
    group = split.group if split is not None else None
    xf = x.reshape(n, d)
    probs, gates, idx = _gates(xf, wg, top_k)
    if data is None:
        pos = _positions(idx, e)
        top1 = idx[:, 0]
        n_all = n
    else:
        every = split.global_idx(idx, b, t)
        pos = split.local_rows(_positions(every, e), b, t)
        top1 = every[:, 0]
        n_all = n * split.ranks
    in_cap = pos < c
    dispatched = in_cap & (gates > 0)
    if split is not None:
        split.kept = dispatched
    # this rank's experts: [e0, e0 + el)
    el = w1.shape[0]
    e0 = split.e0 if split is not None else 0
    mine = (idx >= e0) & (idx < e0 + el)
    slot = (idx - e0) * c + pos
    trash = torch.full_like(slot, el * c)
    rows = _coll.copy_to(xf, group)
    rows = rows[:, None, :].expand(n, top_k, d).reshape(n * top_k, d)
    x_e = xf.new_zeros((el * c + 1, d)).index_copy(
        0, torch.where(dispatched & mine, slot, trash).reshape(-1), rows)
    x_e = x_e[:el * c].reshape(el, c, d)
    h = _dots.matmul(x_e, w1) + b1[:, None, :]
    h = _ACTIVATIONS[activation](h).to(xf.dtype)
    if split is not None and not split.tp0:
        # the first tp rank adds b2; the others add an exact zero whose
        # gradient is b2's
        b2 = b2 - b2.detach()
    y_e = (_dots.matmul(h, w2) + b2[:, None, :]).float()
    y_e = torch.cat([y_e.reshape(el * c, d), y_e.new_zeros((1, d))])
    picked = y_e.index_select(
        0, torch.where(in_cap & mine, slot, trash).reshape(-1)).reshape(
            n, top_k, d)
    w = _coll.copy_to(gates, group) * in_cap
    y = _coll.reduce_from((picked * w[..., None]).sum(dim=1), group)
    frac = F.one_hot(top1, e).float().mean(dim=0)
    mean_prob = _coll.psum(probs.sum(dim=0), data) / n_all
    aux = e * torch.sum(frac * mean_prob)
    kept = dispatched.float().sum()
    if data is not None:
        kept = _coll.all_reduce(kept, data)
    dropped = 1.0 - kept / (n_all * top_k)
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
    call's aux loss and dropped share (detached, on the device).  Over a
    mesh, the module docstring's expert and data parallelism."""

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
        for name, shape, init, axes in (
                ("gate", (num_experts, units), "xavier", (None, "embed")),
                ("w1", (num_experts, units, hidden_size), "xavier",
                 ("expert", "embed", "mlp")),
                ("b1", (num_experts, hidden_size), "zeros",
                 ("expert", "mlp")),
                ("w2", (num_experts, hidden_size, units), "xavier",
                 ("expert", "mlp", "embed")),
                ("b2", (num_experts, units), "zeros", ("expert", "embed"))):
            annotate(self._new_param(name, shape, dtype, init=init), *axes)
        self.last_aux = self.last_dropped = self._last_kept = None

    def capacity(self, n_tokens: int) -> int:
        cap = int(math.ceil(self._top_k * n_tokens / self._num_experts
                            * self._capacity_factor))
        return max(cap, self._top_k)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        split = _Split(self)
        y, aux, dropped = _moe_ffn(
            *_amp.cast("moe_ffn", x, self.gate, self.w1, self.b1, self.w2,
                       self.b2),
            num_experts=self._num_experts, top_k=self._top_k,
            capacity=self.capacity(b * t * split.ranks),
            activation=self._act_name, split=split)
        # recorded only where a loss of the same (micro)batch drains it
        if _base.is_recording() or _base.aux_collection_active():
            _base.record_aux_loss(aux)
        self.last_aux, self.last_dropped = aux.detach(), dropped
        # this rank's (token, choice) pairs an expert took
        self._last_kept = split.kept
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
