"""Logical-axis sharding rules (counterpart of
``mxnet_tpu/parallel/sharding.py``).

Parameters carry logical axis names ("embed", "mlp", "heads", "vocab",
...) and a rules table maps them to mesh axes; the specs equal the
reference's.  What differs is what a spec does.  Under GSPMD a
``NamedSharding`` places a global array's shards on the devices.  The
port runs one process per rank with explicit collectives, and under the
data and sequence parallelism it runs (``dp``, ``sp``) every parameter
stays whole on every rank: :func:`shard_params` is MXNet's KVStore
broadcast (rank 0's values to every rank of the group), and a batch's
:class:`NamedSharding` says which block of the global batch each rank
holds (:meth:`NamedSharding.local_slices`, :func:`local_shard`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import base as _base
from .mesh import Mesh, axis_size

__all__ = ["DEFAULT_RULES", "ShardingRules", "PartitionSpec",
           "NamedSharding", "annotate", "logical_axes_of",
           "mesh_device_put", "param_sharding", "divisible_spec",
           "shard_params", "batch_spec", "global_batch_sharding",
           "local_shard", "is_local_shard", "mark_local_shard",
           "check_placement"]

# Default logical→mesh mapping (Megatron-style TP + sequence axis).
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "dp",
    "layers": "pp",
    "vocab": "tp",
    "embed": None,
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "expert": "ep",
    "seq": "sp",
    "norm": None,
}


class PartitionSpec(tuple):
    """One mesh axis name (or None: replicated) per array dimension (the
    role of ``jax.sharding.PartitionSpec``, a tuple as there)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding:
    """A :class:`Mesh` and a :class:`PartitionSpec`: where each block of a
    global array lives (the role of ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and tuple(other.spec) == tuple(self.spec)

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The shape of one rank's block of a ``global_shape`` array."""
        out = []
        for i, dim in enumerate(global_shape):
            a = self.spec[i] if i < len(self.spec) else None
            n = axis_size(self.mesh, a) if a is not None else 1
            if dim % n:
                raise _base.MXNetError(
                    f"dim {i} of {tuple(global_shape)} does not divide "
                    f"over mesh axis {a!r} of size {n}")
            out.append(dim // n)
        return tuple(out)

    def local_slices(self, global_shape, rank: Optional[int] = None):
        """The slices of ``global_shape`` that ``rank`` (default this
        process) holds."""
        coords = self.mesh.coords(rank)
        shard = self.shard_shape(global_shape)
        out = []
        for i, n in enumerate(shard):
            a = self.spec[i] if i < len(self.spec) else None
            j = coords[a] if a is not None else 0
            out.append(slice(j * n, (j + 1) * n))
        return tuple(out)


class ShardingRules(dict):
    """dict logical-axis-name → mesh-axis-name (or None = replicate)."""

    def __init__(self, rules: Optional[Dict[str, Optional[str]]] = None,
                 **overrides):
        super().__init__(DEFAULT_RULES)
        if rules:
            self.update(rules)
        self.update(overrides)

    def spec(self, logical_axes: Optional[Sequence[Optional[str]]]
             ) -> PartitionSpec:
        """PartitionSpec for a parameter annotated with logical axes."""
        if not logical_axes:
            return P()
        return P(*[self.get(a) if a is not None else None
                   for a in logical_axes])


def annotate(param, *logical_axes):
    """Attach logical axis names to a Parameter (one per dimension)."""
    param._logical_axes = tuple(logical_axes)
    return param


def logical_axes_of(param) -> Optional[Tuple[Optional[str], ...]]:
    return getattr(param, "_logical_axes", None)


def mesh_device_put(value, sharding: NamedSharding):
    """This rank's block of the global array ``value`` under
    ``sharding``, on this rank's device (the reference's multi-process
    ingest: every process holds the full value and keeps its own
    shard)."""
    from .distributed import local_device
    return local_shard(value, sharding, device=local_device())


def param_sharding(param, mesh: Mesh,
                   rules: Optional[ShardingRules] = None) -> NamedSharding:
    rules = rules or ShardingRules()
    return NamedSharding(mesh, rules.spec(logical_axes_of(param)))


def divisible_spec(shape, logical_axes, mesh: Mesh, mapping
                   ) -> PartitionSpec:
    """PartitionSpec mapping each logical axis through ``mapping``
    (logical name → mesh axis name), replicating any dimension whose
    size does not divide its mesh axis (the reference's serving
    fallback)."""
    spec = []
    axes = tuple(logical_axes or ())
    for i, dim in enumerate(shape):
        a = axes[i] if i < len(axes) else None
        m = mapping.get(a) if a is not None else None
        if m is not None:
            sz = axis_size(mesh, m)
            if sz > 1 and dim % sz == 0:
                spec.append(m)
                continue
        spec.append(None)
    return P(*spec)


def shard_params(block, mesh: Mesh, rules: Optional[ShardingRules] = None):
    """Make every initialized parameter of ``block`` equal rank 0's on
    every rank of the mesh (MXNet's KVStore broadcast, parity
    ``src/kvstore/comm.h`` Comm::Broadcast): ranks that initialized from
    different seeds start from one set of weights.  Under dp and sp every
    parameter stays whole, so the rules only record each parameter's
    spec (``p._sharding``)."""
    from . import collectives
    rules = rules or ShardingRules()
    params = []
    for p in block.parameters():
        if not _initialized(p):
            continue
        p._sharding = NamedSharding(mesh, rules.spec(logical_axes_of(p)))
        params.append(p)
    group = mesh.group(tuple(a for a in mesh.axis_names))
    if group is not None and params:
        with torch.no_grad():
            collectives.broadcast_([p.data for p in params],
                                   src=int(mesh.devices.flat[0]),
                                   group=group)
    return block


def _initialized(p) -> bool:
    from ..gluon.parameter import is_initialized
    return is_initialized(p)


def batch_spec(ndim: int, batch_axis: int = 0, seq_axis: Optional[int] = None
               ) -> PartitionSpec:
    """PartitionSpec for an input batch: batch dim over dp, optional
    sequence dim over sp, rest replicated."""
    axes: list = [None] * ndim
    axes[batch_axis] = "dp"
    if seq_axis is not None:
        axes[seq_axis] = "sp"
    return P(*axes)


def global_batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0,
                          seq_axis: Optional[int] = None) -> NamedSharding:
    """The ``NamedSharding`` an input batch lands under; feed it to
    ``ShardedLoader`` / ``DevicePrefetcher`` and to the trainer's
    ``data_specs`` and both sides agree on placement by construction."""
    return NamedSharding(mesh, batch_spec(ndim, batch_axis, seq_axis))


def local_shard(value, sharding: NamedSharding, device=None):
    """This rank's block of the global array ``value`` (numpy array,
    tensor or NDArray) under ``sharding``, as a tensor on ``device``
    (default: where it is), marked as a local shard
    (:func:`is_local_shard`)."""
    from ..ndarray.ndarray import NDArray
    if isinstance(value, NDArray):
        value = value.tensor
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    out = value[sharding.local_slices(tuple(value.shape))]
    if device is not None:
        out = out.to(device)
    return mark_local_shard(out.contiguous(), sharding)


def is_local_shard(x) -> bool:
    """Whether ``x`` (a tensor or NDArray) is a rank's block made by
    :func:`local_shard` (or a loader over a mesh placement), not a
    global array."""
    return getattr(getattr(x, "_t", x), "_mxt_sharding", None) is not None


def mark_local_shard(t: torch.Tensor, sharding: NamedSharding):
    """Mark tensor ``t`` as this rank's block under ``sharding``."""
    t._mxt_sharding = sharding
    return t


def check_placement(sharding: NamedSharding):
    """Raise unless ``sharding``'s mesh runs only ``dp`` and ``sp``."""
    wider = {a: n for a, n in sharding.mesh.shape.items()
             if a not in ("dp", "sp") and n > 1}
    if wider:
        raise _base.MXNetError(
            f"a placement over mesh axes {wider}: the port places batches "
            "over dp and sp; tensor, expert and pipeline parallelism are "
            "ROADMAP queue A6")
