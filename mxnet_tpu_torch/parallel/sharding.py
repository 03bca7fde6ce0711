"""Logical-axis sharding rules (counterpart of
``mxnet_tpu/parallel/sharding.py``).

Parameters carry logical axis names ("embed", "mlp", "heads", "vocab",
...) and a rules table maps them to mesh axes; the specs equal the
reference's.  What differs is what a spec does.  Under GSPMD a
``NamedSharding`` places a global array's shards on the devices.  The
port runs one process per rank with explicit collectives:
:func:`shard_params` makes every rank start from rank 0's values
(MXNet's KVStore broadcast), then keeps on each rank only its block of
every parameter whose spec names a live ``tp``, ``ep`` or ``pp`` axis
(:meth:`NamedSharding.local_slices`, the shard the reference's device
holds); the layers see that their weights are blocks
(:func:`block_mesh`) and write out the collectives GSPMD inserts.  A
batch's :class:`NamedSharding` says which block of the global batch each
rank holds (:func:`local_shard`): rows over ``dp``, the sequence over
``sp``, the same rows on every rank of a ``tp``, ``ep`` or ``pp`` line.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import base as _base
from .mesh import Mesh, axis_size

__all__ = ["DEFAULT_RULES", "ShardingRules", "PartitionSpec",
           "NamedSharding", "annotate", "logical_axes_of",
           "mesh_device_put", "param_sharding", "divisible_spec",
           "shard_params", "batch_spec", "global_batch_sharding",
           "local_shard", "is_local_shard", "mark_local_shard",
           "check_placement", "block_mesh", "global_shape", "MODEL_AXES",
           "DATA_AXES", "vocab_block", "gather_vocab"]

#: the axes that split parameters into blocks, and those that split
#: batches
MODEL_AXES = ("pp", "ep", "tp")
DATA_AXES = ("dp", "sp")

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
    ``src/kvstore/comm.h`` Comm::Broadcast), so ranks that initialized
    from different seeds start from one set of weights, then keep on
    each rank its block of every parameter whose spec (``p._sharding``)
    names a ``tp``, ``ep`` or ``pp`` axis above 1: rank 0's whole value
    sliced as :meth:`NamedSharding.local_slices` says.  A dimension that
    its axis does not divide raises before any parameter changes, as
    ``jax.device_put`` refuses it.  A parameter that is a block already
    is left as it is."""
    from . import collectives
    rules = rules or ShardingRules()
    params, cuts = [], []
    for p in block.parameters():
        if not _initialized(p):
            continue
        sh = NamedSharding(mesh, rules.spec(logical_axes_of(p)))
        shape = global_shape(p)
        cut = any(a in MODEL_AXES and axis_size(mesh, a) > 1
                  for a in sh.spec)
        # raises on a dimension its axis does not divide
        cuts.append(sh.local_slices(shape) if cut and not is_block(p)
                    else None)
        params.append((p, sh))
    whole = [p.data for (p, _), c in zip(params, cuts)
             if not is_block(p)]
    # outside a job (no groups) this process keeps rank 0's blocks
    group = mesh.group(mesh.axis_names) if dist.is_initialized() else None
    with torch.no_grad():
        if group is not None and whole:
            collectives.broadcast_(whole, src=int(mesh.devices.flat[0]),
                                   group=group)
        for (p, sh), sl in zip(params, cuts):
            if sl is not None:
                p._mxt_global_shape = tuple(p.shape)
                p.data = p.data[sl].clone()
            p._sharding = sh
    return block


def is_block(param) -> bool:
    """Whether ``param`` holds a rank's block of a larger parameter
    (:func:`shard_params`)."""
    return getattr(param, "_mxt_global_shape", None) is not None


def global_shape(param) -> Tuple[int, ...]:
    """The shape of the whole parameter ``param`` is (a block of)."""
    return tuple(getattr(param, "_mxt_global_shape", None)
                 or tuple(param.shape))


def block_mesh(param, axis: str) -> Optional[Mesh]:
    """The mesh whose ``axis`` splits ``param`` into this rank's block,
    or None where the parameter is whole along ``axis``.  A block used
    outside a ``use_mesh`` of that mesh raises ``MXNetError``: its
    layer's collectives need the mesh (the reference's sharded arrays
    gather silently instead; a divergence by design, ROADMAP queue C)."""
    sh = getattr(param, "_sharding", None)
    if sh is None or not is_block(param) or axis not in tuple(sh.spec) \
            or axis_size(sh.mesh, axis) == 1:
        return None
    from .mesh import current_mesh
    cur = current_mesh()
    if cur is not sh.mesh and (cur is None or cur.devices.shape !=
                               sh.mesh.devices.shape or
                               not (cur.devices == sh.mesh.devices).all()):
        raise _base.MXNetError(
            f"a parameter of shape {tuple(param.shape)} is this rank's "
            f"block of {global_shape(param)} split over mesh axis "
            f"{axis!r}: call the net under parallel.use_mesh(mesh) of the "
            "mesh it was sharded over (its layers' collectives run over "
            "that mesh)")
    return sh.mesh


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
    """Raise unless ``sharding`` splits a batch over ``dp`` and ``sp``
    only: along ``tp``, ``ep`` and ``pp`` every rank takes the same rows,
    as :func:`batch_spec` places them."""
    wider = {a: axis_size(sharding.mesh, a) for a in sharding.spec
             if a is not None and a not in DATA_AXES
             and axis_size(sharding.mesh, a) > 1}
    if wider:
        raise _base.MXNetError(
            f"a batch placement {tuple(sharding.spec)} over mesh axes "
            f"{wider}: batches split over dp and sp, and every rank of a "
            "tp, ep or pp line takes the same rows")


def vocab_block(t) -> Optional[Mesh]:
    """The mesh over whose ``tp`` tensor ``t`` is this rank's block of the
    last (vocabulary) dimension (``mark_local_shard`` with a spec ending
    in ``tp``: the tied heads' logits), or None for a whole tensor."""
    sh = getattr(t, "_mxt_sharding", None)
    if sh is None or len(sh.spec) < 1 or sh.spec[-1] != "tp" or \
            axis_size(sh.mesh, "tp") == 1:
        return None
    return sh.mesh


def gather_vocab(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a vocabulary block (:func:`vocab_block`) joined with
    the other ``tp`` ranks' along the last dim, whose gradient is this
    rank's columns of the whole's (every rank of the line computes the
    same from it); any other tensor as it is."""
    mesh = vocab_block(t)
    if mesh is None:
        return t
    from . import collectives
    return collectives.gather_cat(t, mesh.group("tp"), -1, grad="slice")
