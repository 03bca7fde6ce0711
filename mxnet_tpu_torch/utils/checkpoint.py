"""Sharded asynchronous checkpoints (counterpart of
``mxnet_tpu/utils/checkpoint.py``).

The reference writes orbax checkpoints; the port writes
``torch.distributed.checkpoint`` (DCP) ones: one directory per step
under ``directory`` (``<directory>/<step>``), whose ``.metadata`` file,
written last, marks the step complete.  The file format differs from
orbax's by design (ROADMAP queue C).  Every rank of a process group calls
``save`` together; a tensor that every rank holds whole (the parameters
and optimizer state under data and sequence parallelism) is written
once.  A tensor of which each rank holds a block (a parameter split
over ``tp``, ``ep`` or ``pp``) is given as a :class:`Block` and written
as a sharded tensor, each block at its offsets by one rank.  A
checkpoint saved by one world size or mesh loads under another (DCP
reshards on load), and loads in a process with no group at all.

``save`` snapshots the tree into host memory before it returns (the
copy that the next step cannot overwrite) and writes it on a background
thread when ``async_save`` is on; ``wait_until_finished`` waits for the
write.  ``restore`` returns CPU tensors shaped like ``like``'s leaves.

``process_group`` is the group of ranks that save together (default:
the job's, or this process alone outside a job); ``no_dist=True`` saves
from this process alone.  An asynchronous save's writer thread runs
collectives on that group, so a trainer gives its checkpoints a gloo
group of their own (``ShardedTrainer.save_checkpoint``), apart from the
group its steps reduce over.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

from .. import base as _base
from ..resilience.faults import inject as _inject

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "Block"]


class Block:
    """This rank's block ``local`` of a tensor of ``global_shape``, at
    ``offsets`` in it.  ``blocks`` lists (offsets, sizes, rank in the
    saving group) of every block that is written, one rank each; this
    rank writes ``local`` where it is among them."""

    def __init__(self, local, global_shape, offsets, blocks):
        self.local = local
        self.global_shape = tuple(global_shape)
        self.offsets = tuple(offsets)
        self.blocks = [(tuple(o), tuple(z), int(r)) for o, z, r in blocks]

    def sharded(self, group):
        """A CPU copy as a ``ShardedTensor`` over ``group`` (no
        communication: every rank knows the layout)."""
        import torch.distributed as dist
        from torch.distributed._shard.metadata import ShardMetadata
        from torch.distributed._shard.sharded_tensor import (
            Shard, ShardedTensor, ShardedTensorMetadata)
        from torch.distributed._shard.sharded_tensor.metadata import \
            TensorProperties
        me = dist.get_rank(group)
        metas = [ShardMetadata(list(o), list(z), f"rank:{r}/cpu")
                 for o, z, r in self.blocks]
        mine = [Shard(self.local.detach().to("cpu", copy=True), m)
                for m, (o, _z, r) in zip(metas, self.blocks)
                if r == me and o == self.offsets]
        md = ShardedTensorMetadata(metas, torch.Size(self.global_shape),
                                   TensorProperties(dtype=self.local.dtype))
        return ShardedTensor._init_from_local_shards_and_global_metadata(
            mine, md, process_group=group)


def _tensor_tree(tree):
    """The tree with every NDArray unwrapped and every leaf a tensor."""
    from ..ndarray.ndarray import NDArray
    if isinstance(tree, dict):
        return {str(k): _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, Block):
        return tree
    if isinstance(tree, NDArray):
        return tree.tensor
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.as_tensor(tree)


def _snapshot(tree, group=None):
    """Every leaf copied into host memory this save owns (a
    :class:`Block` as a sharded tensor over ``group``)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v, group) for k, v in tree.items()}
    if isinstance(tree, Block):
        return tree.sharded(group if group is not None else
                            torch.distributed.group.WORLD)
    return tree.detach().to("cpu", copy=True)


def _has_block(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_block(v) for v in tree.values())
    return isinstance(tree, Block)


class _Staged:
    """``dcp.async_save``'s stager of a state that is a host snapshot
    already: nothing to copy."""

    _synchronize_after_execute = False
    should_synchronize_after_execute = False

    def stage(self, state_dict):
        return state_dict

    def synchronize_staging(self):
        pass

    def close(self):
        pass


def _coordinator(group, no_dist) -> bool:
    """Whether this process writes the shared files (rank 0 of the
    saving group)."""
    import torch.distributed as dist
    if no_dist or not dist.is_initialized():
        return True
    return dist.get_rank(group) == 0


class CheckpointManager:
    """Step-numbered DCP checkpoints under one directory, the newest
    ``max_to_keep`` kept.  Usable as a context manager: exit waits for an
    in-flight save and closes.  ``close()`` is idempotent."""

    def __init__(self, directory, max_to_keep: int = 5,
                 save_interval_steps: int = 1, async_save: bool = True,
                 process_group=None, no_dist: bool = False):
        self.directory = os.path.abspath(directory)
        self._group, self._no_dist = process_group, bool(no_dist)
        self._lead = _coordinator(process_group, no_dist)
        if self._lead:
            os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._interval = max(1, int(save_interval_steps))
        self._async = bool(async_save)
        self._pending = None
        self._closed = False

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, tree: Any) -> bool:
        """Checkpoint ``tree`` (nested dicts of tensors or NDArrays) as
        ``step``; False when ``step`` falls between save intervals."""
        import torch.distributed.checkpoint as dcp
        _inject("checkpoint.save")
        if self._closed:
            raise _base.MXNetError(
                f"CheckpointManager for {self.directory} is closed")
        if step % self._interval:
            return False
        self.wait_until_finished()
        tree = _tensor_tree(tree)
        state = _snapshot(tree, self._group)
        kw = dict(checkpoint_id=self._path(step),
                  process_group=self._group, no_dist=self._no_dist)
        if self._async:
            if _has_block(tree):
                # the snapshot is the staged copy (DCP's own stager cannot
                # copy a sharded tensor)
                kw["async_stager"] = _Staged()
            self._pending = dcp.async_save(state, **kw)
        else:
            dcp.save(state, **kw)
            self._collect()
        return True

    def _collect(self):
        """Drop the oldest complete steps beyond ``max_to_keep`` (rank 0)."""
        if not self._max_to_keep or not self._lead:
            return
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self._max_to_keep)]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def restore(self, step: Optional[int] = None, like: Any = None):
        """The tree of ``step`` (default the latest), its leaves as CPU
        tensors shaped like ``like``'s (the saved tree when None)."""
        import torch.distributed.checkpoint as dcp
        _inject("checkpoint.restore")
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise _base.MXNetError(
                f"no checkpoint found under {self.directory} "
                f"(all_steps={self.all_steps()})")
        if like is None:
            like = self._saved_tree(step)
        out = _snapshot(_tensor_tree(like))
        dcp.load(out, checkpoint_id=self._path(step),
                 process_group=self._group, no_dist=self._no_dist)
        return out

    def _saved_tree(self, step):
        """An empty tree of the saved leaves' shapes and dtypes."""
        from torch.distributed.checkpoint import FileSystemReader
        meta = FileSystemReader(self._path(step)).read_metadata()
        tree: dict = {}
        for key, md in meta.state_dict_metadata.items():
            node = tree
            *parents, leaf = key.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.empty(tuple(md.size),
                                     dtype=md.properties.dtype)
        return tree

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """The complete steps (their ``.metadata`` written), ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, ".metadata")))

    def wait_until_finished(self):
        if self._pending is not None:
            pending, self._pending = self._pending, None
            # a Future, or (newer torch) a response holding one
            getattr(pending, "upload_completion", pending).result()
            self._collect()

    def close(self):
        if self._closed:
            return
        self.wait_until_finished()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def save_checkpoint(directory, step: int, tree, async_save=True,
                    max_to_keep=5):
    """One-shot convenience save (waits for the write)."""
    with CheckpointManager(directory, max_to_keep=max_to_keep,
                           async_save=async_save) as m:
        m.save(step, tree)


def load_checkpoint(directory, step=None, like=None):
    with CheckpointManager(directory, async_save=False) as m:
        return m.restore(step, like=like)
