"""Pipeline parallelism over the ``pp`` mesh axis, the GPipe schedule
(counterpart of ``mxnet_tpu/parallel/pipeline.py``).

The model's repeated trunk is a stack of per-layer parameters (leading
dim = layers, ``models/stacked.py``); under ``pp`` each rank holds its
stage's contiguous slice of the stack and runs it.  The reference runs
the stages inside ``shard_map`` as a ``lax.scan`` over ``M + P - 1``
ticks with ``ppermute`` between neighbours; the port runs the same ticks
in each rank's process, and the hand-over is
``collectives.pipe_shift`` (a send to the next stage and a receive from
the previous, batched; gloo stages CUDA tensors through pinned host
memory).  At tick ``s`` stage 0 takes microbatch ``s`` and every other
stage what its predecessor sent at tick ``s - 1``; the last stage's
outputs of ticks ``P - 1 .. M + P - 2`` are the microbatches' outputs,
and they reach every stage as the reference's ``psum`` of the masked
outputs does (``collectives.from_owner``).  A stage computes only at the
M ticks it holds a microbatch.  The backward is the reverse pipeline
through the hand-overs' autograd, so utilization is GPipe's M / (M + P -
1) both ways.  The gradient of the outputs returns to the last stage
alone: each stage that computes a loss from them gets the true gradient
of its parameters and of ``x`` from its own backward, as the reference's
``jax.grad`` of the whole computation gives.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from . import collectives as _coll
from .mesh import axis_size, current_mesh

__all__ = ["gpipe"]


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], params,
          x, *, num_microbatches: int, mesh=None, axis: str = "pp",
          batch_axis: str = "dp"):
    """Run ``x`` through ``P`` pipeline stages with GPipe microbatching.

    stage_fn(stage_params, x_mb) -> y_mb, same shape as ``x_mb``.
    ``params``: a tree (tuples, lists, dicts) of tensors whose leading
    dim is the stage: ``P`` (every stage's; stage ``i`` uses ``leaf[i]``)
    or 1 (this rank's stage, as ``parallel.shard_params`` keeps a
    ``layers`` stack split over ``pp``).  ``x``: this rank's (B/|dp|,
    ...) block of the batch, the same on every stage, with B/|dp|
    divisible by ``num_microbatches`` (which should be >= P for
    reasonable utilization).  Returns the stages' output for ``x`` on
    every stage.  Every rank of the ``axis`` line calls it together."""
    mesh = mesh or current_mesh()
    p = axis_size(mesh, axis) if mesh is not None else 1
    stage = mesh.axis_index(axis) if p > 1 else 0

    def local(a):
        if a.shape[0] == p:
            return a[stage]
        if a.shape[0] == 1:
            return a[0]
        raise ValueError(f"gpipe: a parameter of leading dim {a.shape[0]} "
                         f"is neither the {p} stages' nor one stage's")
    stage_params = _tree_map(local, params)
    if p == 1:
        return stage_fn(stage_params, x)
    m = num_microbatches
    dpn = axis_size(mesh, batch_axis)
    bl = x.shape[0]
    if bl % m:
        raise ValueError(
            f"per-{batch_axis}-shard batch {bl * dpn}//{dpn} must be "
            f"divisible by num_microbatches={m}")
    group = mesh.group(axis)
    micro = x.reshape(m, bl // m, *x.shape[1:])
    first = torch.tensor(stage == 0, device=x.device)
    recv = torch.zeros_like(micro[0])
    outs = []
    for step in range(m + p - 1):
        # stage 0 feeds microbatches; the others take what arrived (both
        # stay in the graph, so every stage runs every hand-over's
        # backward)
        x_in = torch.where(first, micro[min(step, m - 1)], recv)
        # a stage holds a microbatch at ticks [stage, stage + M); at the
        # others what it passes on reaches no output, so it is not
        # computed (the reference's scan computes it and masks it out)
        busy = stage <= step < stage + m
        y = stage_fn(stage_params, x_in) if busy else x_in
        if step >= p - 1:
            outs.append(y)
        if step < m + p - 2:
            recv = _coll.pipe_shift(y, group)
    # only the last stage holds real outputs: every stage gets them, and
    # their gradient returns to the last stage
    out = _coll.from_owner(torch.stack(outs), group, stage == p - 1)
    return out.reshape(x.shape)
