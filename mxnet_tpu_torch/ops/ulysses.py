"""Ulysses (all-to-all) sequence parallelism over the ``sp`` mesh axis
(counterpart of ``mxnet_tpu/ops/ulysses.py``).

The DeepSpeed-Ulysses recipe: each rank passes its natural-order
sequence chunk (B/dp, T/sp, H, D), as to ring attention
(``ops/ring.py``); one all-to-all re-shards q, k and v over the heads (a
rank receives the whole sequence for H/sp of the heads),
``attention.flash_attention`` runs on the whole sequence (B1 forward,
B2/B3 backward on the card), and a second
all-to-all restores the sequence split.  The all-to-alls are
differentiable (each one's backward is the inverse all-to-all).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel import collectives as _coll
from ..parallel.mesh import axis_size, current_mesh
from .attention import flash_attention

__all__ = ["ulysses_attention", "nd_ulysses_attention"]


class _AllToAll(torch.autograd.Function):
    """``collectives.all_to_all`` with its inverse as the backward."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.meta = (group, split_dim, concat_dim)
        return _coll.all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.meta
        return (_coll.all_to_all(g.contiguous(), group, concat_dim,
                                 split_dim), None, None, None)


def ulysses_attention(q, k, v, *, causal: bool = False,
                      scale: Optional[float] = None, mesh=None,
                      axis: str = "sp", batch_axis: str = "dp",
                      heads_axis: str = "tp"):
    """Sequence-parallel attention on this rank's (B/dp, T/sp, H', D)
    chunks via head/sequence all-to-all re-sharding, where H' is this
    rank's heads: H / |heads_axis| where tensor parallelism splits them
    (``models/transformer.py``), else H.  Requires H' divisible by
    |axis|."""
    mesh = mesh or current_mesh()
    sp = axis_size(mesh, axis) if mesh is not None else 1
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if sp == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    t, h = q.shape[1], q.shape[2]
    tp = axis_size(mesh, heads_axis)
    if k.shape[1] != t:
        raise ValueError(
            f"ulysses attention needs tq == tk divisible by |{axis}|={sp},"
            f" got tq={t * sp}, tk={k.shape[1] * sp}")
    # the whole model's heads: this rank holds H / |tp| of them
    h = h * tp
    if h % tp or (h // tp) % sp:
        raise ValueError(
            f"ulysses attention needs heads {h} divisible by "
            f"|{heads_axis}|={tp} and local heads {h}//{tp} divisible by "
            f"|{axis}|={sp}")
    group = mesh.group(axis)
    # sequence split -> heads split: every rank gets the whole sequence
    # for its H/sp heads
    q, k, v = (_AllToAll.apply(x, group, 2, 1) for x in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    # heads split -> sequence split
    return _AllToAll.apply(out, group, 1, 2)


def nd_ulysses_attention(query, key, value, *, causal=False, scale=None,
                         mesh=None, axis="sp"):
    """NDArray-level entry (autograd-recorded) for Ulysses attention."""
    from ..ndarray.ops import _as_nd, invoke
    query, key, value = _as_nd(query), _as_nd(key), _as_nd(value)

    def f(q, k, v):
        return ulysses_attention(q, k, v, causal=causal, scale=scale,
                                 mesh=mesh, axis=axis)

    return invoke("ulysses_attention", f, [query, key, value])
