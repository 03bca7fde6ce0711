"""Sharded decode: the serving engine over a mesh of ranks (counterpart
of the reference's ``_init_mesh``, ``_mesh_params`` and its GSPMD
programs, ``mxnet_tpu/serving/engine.py:801-911``, ``:1279-1406``).

The reference's engine is one process whose jitted programs span the
mesh's devices.  The port is SPMD, as Megatron-LM and vLLM serve: one
process per rank, and every rank of the mesh builds the engine.

- **Rank 0 leads.**  The mesh's first rank runs the scheduler, the
  batcher, the page allocator and the prefix tree, and is the only rank
  whose ``submit`` is accepted.  Before each program call it broadcasts
  a plan over the mesh's group: the program's key, its host inputs
  (tokens, positions, slot indices, sampling rows and seeds) and the
  cache surgery done since the last plan (the page table, scrubbed
  pages, zeroed rows, a scale poison).
- **The others follow.**  Their ``start()`` (or ``with engine:``) runs a
  loop that receives each plan, applies the surgery to their own caches
  and runs the same program on their own heads (and, with a slot axis,
  their own KV rows), until rank 0's ``stop`` ends it.  While rank 0 is
  idle it sends a beat every :data:`BEAT` seconds, so a follower never
  waits on the group's timeout.
- **A status word.**  After a plan has been applied and before the
  program runs, the ranks take the max of a status word: a follower that
  failed to apply a plan (this call's, or a beat's since the last call)
  says so there, and rank 0 condemns the engine
  (:class:`~.errors.EngineCrashedError`) instead of waiting in the
  program's first collective.  A rank that fails inside a program fails
  its peers at the group's timeout; rank 0 then condemns the engine.
  Fault sites fire on rank 0 before the plan leaves, so a retried or
  failed step never reaches the followers.
- **Parameters** are placed by ``divisible_spec``: heads, MLP and
  vocabulary split over the model axis where it divides them, anything
  else replicated (a vocabulary of 97 at tp = 2 stays whole).  The net
  is never touched: the engine runs a shadow of it (its modules copied,
  the replicated parameters shared, each split one this rank's block),
  and a payload changed since the last dispatch (``set_data``, a
  trainer's update) is copied into the block in place, so the programs
  keep their buffers.  Every rank's net must hold the same weights.
- **Logits** are whole on every rank (the model gathers its vocabulary
  block over ``tp``), and with a slot axis gathered over that axis too,
  so every rank samples the same tokens and none is broadcast.
- **The slot axis** (dense layout): rank j of the slot axis holds rows
  ``[j·L, (j+1)·L)`` of the ``R = num_slots + 1 + prefix_pool_rows`` KV
  rows, L = R / |slot axis|, plus one trash row for the writes of batch
  rows it does not hold.  Decode, draft and verify run on its L rows
  (free ones parked, as on one device); a prefill runs the whole batch
  on every rank, each writing the rows it holds; the prefix copy moves a
  row between ranks by a sum over the slot axis.
"""
from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import collectives as _coll
from ..parallel import distributed as _dist
from ..parallel.mesh import AXES, Mesh, axis_size, make_mesh
from ..parallel.sharding import (NamedSharding, divisible_spec,
                                 global_shape, is_block, logical_axes_of)
from .errors import ServingError

__all__ = ["ServingMesh", "BEAT"]

#: seconds between rank 0's beats while its scheduler is idle
BEAT = 1.0

# the engine's programs by the first element of their key
PROGRAMS = {"decode": "_prog_decode", "prefill": "_prog_prefill",
            "chunk": "_prog_chunk", "draft": "_prog_draft",
            "verify": "_prog_verify", "prefix_copy": "_prog_copy"}


def _heads(net) -> Optional[int]:
    return int(net.kv_heads()[0]) if hasattr(net, "kv_heads") else None


def _axes(mesh_axes):
    axes = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
    if not 1 <= len(axes) <= 2 or len(set(axes)) != len(axes):
        raise ServingError(
            f"mesh_axes must be one or two DISTINCT axis names (model "
            f"axis[, slot axis]), got {axes!r}")
    return axes


def _check_heads(heads, model_ax, t):
    if heads is not None and heads % t:
        raise ServingError(
            f"mesh axis {model_ax!r} spans {t} devices, which does not "
            f"divide the model's {heads} attention heads — the KV head "
            "dimension must shard evenly (grow/pad the head count or "
            "shrink the mesh)")


class ServingMesh:
    """The engine's mesh: validated at construction (every
    incompatibility a :class:`ServingError`), the shadow net over this
    rank's blocks, the plan exchange and the slot axis's row
    arithmetic."""

    def __init__(self, engine, mesh, mesh_axes):
        net = engine.net
        if isinstance(mesh, bool) or not isinstance(mesh, (int, Mesh)):
            raise ServingError(
                f"mesh= must be None, a device count, or a "
                f"parallel.Mesh, got {type(mesh).__name__}")
        axes = _axes(mesh_axes)
        heads = _heads(net)
        world = _dist.num_workers()
        if isinstance(mesh, int):
            if mesh < 1:
                raise ServingError(f"mesh={mesh} must be >= 1 devices")
            for a in axes:
                if a not in AXES:
                    raise ServingError(
                        f"mesh_axes entry {a!r} is not an axis of the mesh "
                        f"(axes: {AXES})")
            _check_heads(heads, axes[0], mesh if axes[0] == "tp" else 1)
            if world != mesh:
                raise ServingError(
                    f"mesh={mesh} needs {mesh} devices, one rank a device: "
                    f"this job has {world} ranks — every rank of a job of "
                    f"{mesh} builds the engine (init_distributed, "
                    f"tools/launch.py -n {mesh})")
            mesh = make_mesh(dp=1, tp=mesh)
        for a in axes:
            if a not in mesh.axis_names:
                raise ServingError(
                    f"mesh_axes entry {a!r} is not an axis of the mesh "
                    f"(axes: {tuple(mesh.axis_names)})")
        model_ax = axes[0]
        slot_ax = axes[1] if len(axes) == 2 else None
        t = axis_size(mesh, model_ax)
        _check_heads(heads, model_ax, t)
        if model_ax != "tp" and t > 1:
            raise ServingError(
                f"model axis {model_ax!r} spans {t} devices: the port's "
                "layers split heads, MLP and vocabulary over the mesh's "
                "'tp' axis — name 'tp' as the model axis")
        ranks = [int(r) for r in mesh.devices.flat]
        if mesh.size > 1 and (not dist.is_initialized()
                              or max(ranks) >= world):
            raise ServingError(
                f"a mesh of {mesh.size} devices needs {mesh.size} ranks, "
                f"one process a device (init_distributed, tools/launch.py "
                f"-n {mesh.size}); this job has {world}")
        if _dist.rank() not in ranks:
            raise ServingError(f"rank {_dist.rank()} is not in the mesh "
                               f"{mesh!r}: only its ranks build the engine")
        self.slot_rows = None
        if slot_ax is not None:
            d = axis_size(mesh, slot_ax)
            if engine._paged:
                raise ServingError(
                    "a slot axis in mesh_axes is incompatible with "
                    "kv_layout='paged': physical pages migrate between "
                    "slots, so the page axis has no stable slot mapping to "
                    "shard over — use the model axis alone, or "
                    "kv_layout='dense'")
            rows = engine.num_slots + 1 + engine.prefix_pool_rows
            if rows % d:
                raise ServingError(
                    f"slot axis {slot_ax!r} ({d} devices) does not divide "
                    f"the KV row count num_slots+1+prefix_pool_rows="
                    f"{rows} — pad num_slots or prefix_pool_rows")
            if d > 1:
                # (group, rows a rank holds, its first row, all rows)
                n = rows // d
                self.slot_rows = (mesh.group(slot_ax), n,
                                  mesh.axis_index(slot_ax) * n, rows)
        self.mesh = mesh
        self.axes = axes
        self.model_axis = model_ax
        self.slot_axis = slot_ax
        self.key = "%ddev:%s" % (mesh.size, ",".join(
            "%s=%d" % (a, axis_size(mesh, a)) for a in axes))
        self.leader_rank = ranks[0]
        self.leader = _dist.rank() == self.leader_rank
        self.group = mesh.group(mesh.axis_names) if mesh.size > 1 else None
        self.followers = self.group is not None
        # gloo moves host memory: its collectives cannot be captured
        self.staged = self.followers and _coll.staging(self.group)
        self._device = None
        self.effects = []
        self.broken = False
        self.last_plan = time.monotonic()
        self.plans = {"sent": 0, "bytes": 0, "seconds": 0.0}
        self.shadow = self._place(net, model_ax)

    # ---------------------------------------------------------- placement
    def _place(self, net, model_ax):
        """The shadow of ``net`` over this rank's blocks (module
        docstring); ``self.splits`` lists each block with its source."""
        mapping = {"heads": model_ax, "vocab": model_ax, "mlp": model_ax}
        blocks, self.splits = {}, []
        for mod in net.modules():
            for name, p in mod._parameters.items():
                if p is None:
                    continue
                if is_block(p):
                    raise ServingError(
                        "the net's parameters are blocks of a sharded "
                        "trainer (shard_params): serve a net whose "
                        "parameters are whole; the engine splits them")
                shape = global_shape(p)
                spec = divisible_spec(shape, logical_axes_of(p), self.mesh,
                                      mapping)
                if model_ax not in tuple(spec) or \
                        axis_size(self.mesh, model_ax) == 1:
                    continue
                blk = blocks.get(id(p))
                if blk is None:
                    sh = NamedSharding(self.mesh, spec)
                    sl = sh.local_slices(shape)
                    with torch.no_grad():
                        blk = p.detach()[sl].clone()
                    blk._sharding = sh
                    blk._mxt_global_shape = shape
                    blocks[id(p)] = blk
                    self.splits.append([mod, name, p, p._version,
                                        p.data_ptr(), blk, sl])
                blocks[(id(mod), name)] = blk
        if not self.splits:
            return net
        memo = {}

        def shadow(m):
            s = memo.get(id(m))
            if s is not None:
                return s
            s = memo[id(m)] = copy.copy(m)
            s._parameters = {n: blocks.get((id(m), n), p)
                             for n, p in m._parameters.items()}
            s._modules = {n: None if c is None else shadow(c)
                          for n, c in m._modules.items()}
            for k, v in list(vars(s).items()):
                if isinstance(v, (list, tuple)) and v and all(
                        isinstance(c, torch.nn.Module) for c in v):
                    s.__dict__[k] = type(v)(shadow(c) for c in v)
            return s
        return shadow(net)

    def refresh(self):
        """Copy into its block every split parameter whose payload
        changed since the last dispatch (a new tensor, or an in-place
        update), in place: the programs keep their buffers."""
        for rec in self.splits:
            mod, name, src, ver, ptr, blk, sl = rec
            cur = mod._parameters[name]
            if cur is src and cur._version == ver and \
                    cur.data_ptr() == ptr:
                continue
            with torch.no_grad():
                blk.copy_(cur.detach()[sl])
            rec[2:5] = [cur, cur._version, cur.data_ptr()]

    # ------------------------------------------------------ plan exchange
    def _plan_device(self):
        if self._device is None:
            self._device = torch.device("cpu") \
                if dist.get_backend(self.group) == "gloo" else \
                torch.device("cuda", torch.cuda.current_device())
        return self._device

    def send(self, op, *payload):
        """Rank 0: broadcast plan ``op`` with ``payload`` and the surgery
        queued since the last plan."""
        t0 = time.perf_counter()
        msg = [(op, payload, self.effects)]
        self.effects = []
        dist.broadcast_object_list(msg, src=self.leader_rank,
                                   group=self.group,
                                   device=self._plan_device())
        self.plans["sent"] += 1
        self.plans["bytes"] += plan_bytes(payload)
        self.plans["seconds"] += time.perf_counter() - t0
        self.last_plan = time.monotonic()

    def receive(self):
        """A follower: the next plan, (op, payload, effects)."""
        msg = [None]
        dist.broadcast_object_list(msg, src=self.leader_rank,
                                   group=self.group,
                                   device=self._plan_device())
        return msg[0]

    def status(self, code: int) -> int:
        """The max over the mesh of every rank's status word (0: ok)."""
        t0 = time.perf_counter()
        w = torch.tensor([int(code)], dtype=torch.int32,
                         device=self._plan_device())
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=self.group)
        out = int(w.item())
        self.plans["seconds"] += time.perf_counter() - t0
        return out

    # ------------------------------------------------------- the slot axis
    def rows_local(self, a, fill):
        """This rank's rows of a per-row program input over the decode
        rows (padded with ``fill`` to every KV row first)."""
        if self.slot_rows is None:
            return a
        _g, n, base, rows = self.slot_rows
        if a.shape[0] < rows:
            pad = a.new_full((rows - a.shape[0],) + tuple(a.shape[1:]),
                             fill)
            a = torch.cat([a, pad])
        return a[base:base + n]

    def rows_global(self, t, n):
        """The first ``n`` rows of every rank's rows of ``t``, joined
        over the slot axis."""
        if self.slot_rows is None:
            return t
        return torch.cat(_coll.all_gather(t.contiguous(),
                                          self.slot_rows[0]))[:n]

    def slots_local(self, sidx):
        """Slot ids as this rank's local rows; a row it does not hold
        goes to its trash row (index L)."""
        if self.slot_rows is None:
            return sidx
        _g, n, base, _r = self.slot_rows
        loc = sidx - base
        return torch.where((loc >= 0) & (loc < n), loc,
                           torch.full_like(loc, n))

    def pick_owner(self, t, sidx):
        """Row i of ``t`` from the rank that holds slot ``sidx[i]``."""
        if self.slot_rows is None:
            return t
        g, n, _b, _r = self.slot_rows
        every = torch.stack(_coll.all_gather(t.contiguous(), g))
        return every[(sidx // n).long(),
                     torch.arange(t.shape[0], device=t.device)]

    def local_row(self, row) -> Optional[int]:
        """Global KV row ``row`` as this rank's local row, or None."""
        if self.slot_rows is None:
            return int(row)
        _g, n, base, _r = self.slot_rows
        loc = int(row) - base
        return loc if 0 <= loc < n else None

    def copy_rows(self, caches, src, dst, length):
        """Positions ``[0, length)`` of global row ``src`` into ``dst``
        across the slot axis: the holder of ``src`` gives the row, the
        others zeros, summed over the axis; the holder of ``dst`` writes
        it (the others write their trash row).  No host read."""
        g, n, base, _r = self.slot_rows
        dev = caches[0]["k"].device

        def idx(x):
            return torch.as_tensor(x, device=dev).to(torch.int64).reshape(1)
        src, dst, length = idx(src), idx(dst), idx(length)
        own_src = (src // n) == base // n
        lsrc = (src - base).clamp(0, n - 1)
        ldst = torch.where((dst // n) == base // n, dst - base,
                           torch.full_like(dst, n))
        keep = torch.arange(caches[0]["k"].shape[1], device=dev) < length
        for cache in caches:
            for a in cache.values():
                row = a.index_select(0, lsrc)
                row = torch.where(own_src.reshape((1,) * row.dim()), row,
                                  torch.zeros_like(row))
                row = _coll.all_reduce(row, g)
                m = keep.reshape((1, -1) + (1,) * (a.dim() - 2))
                a.index_copy_(0, ldst, torch.where(
                    m, row, a.index_select(0, ldst)))

    def stats(self) -> dict:
        return {"enabled": True, "devices": int(self.mesh.size),
                "axes": {a: axis_size(self.mesh, a) for a in self.axes},
                "model_axis": self.model_axis, "slot_axis": self.slot_axis,
                "mesh_point": self.key}


def plan_bytes(payload) -> int:
    """The bytes of the host arrays in a plan's payload."""
    if isinstance(payload, np.ndarray):
        return int(payload.nbytes)
    if isinstance(payload, (tuple, list)):
        return sum(plan_bytes(a) for a in payload)
    return 0
