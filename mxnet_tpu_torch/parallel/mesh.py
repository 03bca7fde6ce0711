"""The device mesh (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` over the devices of every
process, and GSPMD inserts the collectives.  The port runs SPMD the
PyTorch way: one process per rank, one device per rank, and explicit
collectives.  So a :class:`Mesh` here is the grid of ranks laid out over
the same five named axes, with one ``torch.distributed`` process group
per line of ranks along a set of axes (:meth:`Mesh.group`), built when
the mesh is made (every rank builds every group, in the same order, as
``new_group`` requires).

Canonical axes, outermost first: ``pp`` (pipeline), ``dp`` (data),
``ep`` (expert), ``sp`` (sequence), ``tp`` (tensor); any of them may be
above 1.  The groups are those of every set of live axes (:meth:`Mesh.
group` takes any tuple of axis names): the data axes for the gradient
sum, ``tp`` for the layers' reductions, ``(ep, tp)`` for the expert
layer's, ``pp`` for the pipeline's sends and its output's broadcast, and
the model axes together for the trainer's global norm and generator.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .. import base as _base
from . import distributed as _dist

__all__ = ["AXES", "Mesh", "make_mesh", "current_mesh", "use_mesh",
           "axis_size"]

AXES = ("pp", "dp", "ep", "sp", "tp")

_current: List["Mesh"] = []


class Mesh:
    """A grid of ranks over named axes (the role of
    ``jax.sharding.Mesh``).  ``devices`` holds each position's rank."""

    def __init__(self, devices, axis_names: Sequence[str] = AXES):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise _base.MXNetError(
                f"mesh grid of rank {self.devices.ndim} for axes "
                f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self._groups: Dict[Tuple[str, ...], object] = {}
        if dist.is_initialized() and self.devices.size > 1:
            self._make_groups()

    # the name torch's DeviceMesh uses
    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of ``rank`` (default this process's) in the
        grid."""
        r = _dist.rank() if rank is None else rank
        where = np.argwhere(self.devices == r)
        if not len(where):
            raise _base.MXNetError(f"rank {r} is not in this mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis of size 1)."""
        return self.coords()[axis] if self.shape.get(axis, 1) > 1 else 0

    def _lines(self, axes: Tuple[str, ...]):
        """The groups of ranks that vary along ``axes`` only."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in dims]
        grid = np.transpose(self.devices, rest + dims)
        n = int(np.prod([self.devices.shape[i] for i in dims]))
        return [sorted(int(r) for r in line)
                for line in grid.reshape(-1, n)]

    def _make_groups(self):
        import itertools
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        # every set of live axes, in one order on every rank (new_group
        # is collective over the job)
        combos = [c for n in range(1, len(live) + 1)
                  for c in itertools.combinations(live, n)]
        from .collectives import tag_group
        me = _dist.rank()
        for axes in combos:
            lines = self._lines(axes)
            if len(lines) == 1 and lines[0] == list(
                    range(dist.get_world_size())):
                self._groups[axes] = dist.group.WORLD
                tag_group(dist.group.WORLD, axes)
                continue
            for line in lines:
                g = dist.new_group(line)
                if me in line:
                    self._groups[axes] = g
                    tag_group(g, axes)

    def group(self, axes="dp"):
        """The process group of this rank's line along ``axes`` (an axis
        name or a tuple of them; axes of size 1 are dropped), or None
        where that line is this rank alone."""
        if isinstance(axes, str):
            axes = (axes,)
        live = tuple(a for a in self.axis_names
                     if a in axes and self.shape.get(a, 1) > 1)
        if not live:
            if dist.is_initialized() and self.size == 1 and \
                    dist.get_world_size() == 1:
                return dist.group.WORLD
            return None
        return self._groups[live]

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(dp: Optional[int] = None, tp: int = 1, pp: int = 1,
              sp: int = 1, ep: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 5-axis mesh over ``devices`` (default: every rank of the job,
    one device each).  ``dp=None`` absorbs whatever the other axes leave
    over.  The mesh needs one process per device: ``devices`` are ranks
    of the job (ints; a subset makes a smaller mesh, and every rank of
    the job makes it together), or any other device handles, one per
    rank of the job.  Every rank calls it with the same arguments."""
    world = _dist.num_workers()
    if devices is None:
        devices = list(range(world))
    n = len(devices)
    fixed = tp * pp * sp * ep
    if dp is None:
        if n % fixed:
            raise _base.MXNetError(
                f"{n} devices not divisible by tp*pp*sp*ep={fixed}")
        dp = n // fixed
    if dp * fixed != n:
        raise _base.MXNetError(
            f"mesh {dp}x{fixed} needs {dp * fixed} devices, have {n}")
    ranks = list(devices) if all(isinstance(d, (int, np.integer))
                                 for d in devices) else list(range(n))
    if n > world or any(not 0 <= r < world for r in ranks) or \
            len(set(ranks)) != n:
        raise _base.MXNetError(
            f"a mesh of {n} devices needs {n} ranks, one process a device "
            f"(init_distributed, tools/launch.py -n {n}); this job has "
            f"{world}")
    sizes = {"pp": pp, "dp": dp, "ep": ep, "sp": sp, "tp": tp}
    grid = np.asarray(ranks, dtype=object).reshape(
        [sizes[a] for a in AXES])
    return Mesh(grid, AXES)


def current_mesh() -> Optional[Mesh]:
    """Innermost active mesh (set via ``with use_mesh(m):``), or None."""
    return _current[-1] if _current else None


class use_mesh:
    """Context manager installing a mesh as the ambient default."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        _current.append(self.mesh)
        return self.mesh

    def __exit__(self, *a):
        _current.pop()


def axis_size(mesh: Mesh, axis: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(axis, 1)
