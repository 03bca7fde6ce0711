"""Per-host sharded global-batch loading.

Counterpart of ``mxnet_tpu/data/sharded_loader.py``.  The reference
materializes on each process only the rows of the global batch that its
addressable devices own and stitches the global array shard by shard.
The port runs one rank per process, so a placement is either one device
(a ``torch.device``, a :class:`Context` or a device string: this process
owns every row, ``host_batch_rows`` is ``(0, batch)``, and
``assemble_global`` is one copy to that device) or a
:class:`~mxnet_tpu_torch.parallel.NamedSharding` over a ``dp`` x ``sp``
mesh (``parallel.global_batch_sharding``, or the trainer's
``batch_shardings``): this process loads only its ``dp`` block of rows,
and ``assemble_global`` keeps its ``sp`` slice of the sequence and puts
it on this rank's device, marked as a local shard that
``ShardedTrainer.step`` takes as it is.  A mesh with ``tp``, ``ep`` or
``pp`` above 1 raises ``MXNetError`` naming ROADMAP queue A6.

Shard assignment is deterministic in ``(epoch, step)``: the sample
permutation is seeded by ``(seed, epoch)`` with plain arithmetic (no
process-salted hashing), so a resumed run replays the exact batches it
would have loaded — ``ResilientLoop`` offset replay and
:meth:`~mxnet_tpu_torch.data.prefetch.DevicePrefetcher.state_dict`
fast-forward both stay bit-identical.

Fault site ``data.bad_shard``: a poisoned shard (NaN/Inf splice, the
``io.bad_batch`` idiom) is quarantined and the step is skipped, counted
— same semantics as ``NDArrayIter(quarantine_nonfinite=True)``.
"""

from typing import Callable, Sequence, Tuple

import numpy as onp
import torch

from .. import base as _base
from ..context import Context, cpu as _cpu, resolve_device
from ..ndarray import NDArray
from ..resilience.faults import poison as _poison
from ..observability.registry import default_registry as _registry

__all__ = ["ShardedLoader", "host_batch_rows", "assemble_global"]


def _named(sharding):
    """``sharding`` if it is a mesh placement (checked), else None."""
    from ..parallel.sharding import NamedSharding, check_placement
    if isinstance(sharding, NamedSharding):
        check_placement(sharding)
        return sharding
    return None


def _one_device(sharding) -> torch.device:
    """The device of a one-device layout; anything wider raises."""
    if isinstance(sharding, (str, torch.device, Context)):
        return resolve_device(sharding)
    if isinstance(sharding, (list, tuple)) and len(
            {resolve_device(s) for s in sharding}) == 1:
        return resolve_device(sharding[0])
    raise _base.MXNetError(
        f"the layout {sharding!r} is neither one device nor a mesh "
        "placement (parallel.NamedSharding; meshes: ROADMAP queue A6)")


def host_batch_rows(sharding, global_shape) -> Tuple[int, int]:
    """The contiguous ``[lo, hi)`` batch-dim row range this process
    must materialize under ``sharding``: on one device, every row; under
    a mesh placement, this rank's ``dp`` block."""
    named = _named(sharding)
    if named is not None:
        rows = named.local_slices(tuple(global_shape))[0]
        return rows.start, rows.stop
    _one_device(sharding)
    return 0, int(tuple(global_shape)[0])


def assemble_global(host_part, sharding, global_shape, lo: int = 0):
    """The batch as this process holds it under ``sharding``, from its
    host rows: on one device the global batch (all rows) on that device;
    under a mesh placement this rank's block (its ``sp`` slice of its
    rows) on its device, marked as a local shard."""
    global_shape = tuple(global_shape)
    named = _named(sharding)
    if named is not None:
        from ..parallel.distributed import local_device
        from ..parallel.sharding import mark_local_shard
        sl = named.local_slices(global_shape)
        host_part = onp.asarray(host_part)
        if lo != sl[0].start or host_part.shape[0] != \
                sl[0].stop - sl[0].start:
            raise _base.MXNetError(
                f"host rows {tuple(host_part.shape)} from {lo} are not "
                f"this rank's rows [{sl[0].start}, {sl[0].stop}) of "
                f"{global_shape}")
        part = onp.ascontiguousarray(host_part[(slice(None),) + sl[1:]])
        return mark_local_shard(
            torch.from_numpy(part).to(local_device()), named)
    dev = _one_device(sharding)
    host_part = onp.asarray(host_part)
    if lo != 0 or tuple(host_part.shape) != global_shape:
        raise _base.MXNetError(
            f"host rows {tuple(host_part.shape)} from {lo} are not the "
            f"global batch {global_shape} of a one-device layout")
    return torch.from_numpy(onp.ascontiguousarray(host_part)).to(dev)


class ShardedLoader:
    """Deterministic per-host sharded global-batch iterator.

    Parameters
    ----------
    load_fn : callable
        ``load_fn(sample_ids) -> (data, labels)`` returning host numpy
        arrays for exactly the given GLOBAL sample ids (this process's
        shard of the batch).  It must be a pure function of the ids —
        that is the whole determinism contract.
    num_samples : int
        Dataset size; permuted per epoch when ``shuffle``.
    batch_size : int
        GLOBAL batch size (all hosts combined).
    sample_shape, label_shape : tuple
        Per-sample shapes (data rows are ``(batch,) + sample_shape``).
    data_sharding, label_sharding : device or NamedSharding, optional
        Target placement (one device, or a ``dp`` x ``sp`` mesh
        placement: this rank's block).  ``None`` keeps host arrays on
        ``mx.cpu()`` (the trainer or a ``DevicePrefetcher`` does the
        placement).
    shuffle : bool
        Per-epoch sample permutation, seeded by ``(seed, epoch)``.
    epochs : int
        Number of epochs one iteration pass covers (ResilientLoop's
        ``make_iter`` wants the GLOBAL step sequence in one iterator).
    quarantine_nonfinite : bool
        Skip (and count) a step whose host shard carries NaN/Inf —
        the ``data.bad_shard`` degradation.
    """

    def __init__(self, load_fn: Callable, num_samples: int,
                 batch_size: int,
                 sample_shape: Sequence[int] = (),
                 label_shape: Sequence[int] = (),
                 data_sharding=None, label_sharding=None,
                 shuffle: bool = False, seed: int = 0, epochs: int = 1,
                 quarantine_nonfinite: bool = True,
                 dtype="float32", label_dtype="float32"):
        if batch_size < 1 or batch_size > num_samples:
            raise _base.MXNetError(
                f"batch_size {batch_size} outside [1, {num_samples}]")
        if (data_sharding is None) != (label_sharding is None):
            raise _base.MXNetError(
                "pass both data_sharding and label_sharding or neither")
        self._load_fn = load_fn
        self._n = int(num_samples)
        self.batch_size = int(batch_size)
        self._sample_shape = tuple(sample_shape)
        self._label_shape = tuple(label_shape)
        self._data_sh = data_sharding
        self._label_sh = label_sharding
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._epochs = int(epochs)
        self._quarantine = bool(quarantine_nonfinite)
        self._dtype = onp.dtype(dtype)
        self._label_dtype = onp.dtype(label_dtype)
        self.steps_per_epoch = self._n // self.batch_size
        self._step = 0          # global step cursor (crosses epochs)
        self.quarantined = 0
        self._served = 0
        self._obs_quarantined = _registry().counter(
            "mxtpu_io_quarantined_batches_total",
            help="non-finite input batches quarantined (never trained "
                 "on), all iterators")
        self._perm_cache: dict = {}

    # -------------------------------------------------------- assignment
    def _perm(self, epoch: int):
        p = self._perm_cache.get(epoch)
        if p is None:
            if self._shuffle:
                # arithmetic key, NOT hash(): hash is process-salted
                # and would break cross-process shard agreement
                rs = onp.random.RandomState(
                    (self._seed * 1000003 + epoch) & 0x7fffffff)
                p = rs.permutation(self._n)
            else:
                p = onp.arange(self._n)
            self._perm_cache[epoch] = p
        return p

    def shard_ids(self, epoch: int, step: int) -> onp.ndarray:
        """The GLOBAL sample ids this process loads for (epoch, step) —
        pure in (process layout, seed, epoch, step); exposed so tests
        can pin determinism directly."""
        B = self.batch_size
        ids = self._perm(epoch)[step * B:(step + 1) * B]
        if self._data_sh is not None:
            lo, hi = host_batch_rows(
                self._data_sh, (B,) + self._sample_shape)
            return ids[lo:hi]
        return ids

    # --------------------------------------------------------- iteration
    def _load_step(self, epoch: int, step: int):
        B = self.batch_size
        ids = self.shard_ids(epoch, step)
        data, labels = self._load_fn(ids)
        data = onp.asarray(data, self._dtype)
        labels = onp.asarray(labels, self._label_dtype)
        want = (len(ids),) + self._sample_shape
        if tuple(data.shape) != want:
            raise _base.MXNetError(
                f"load_fn returned data shape {tuple(data.shape)}, "
                f"expected {want}")
        bad = _poison("data.bad_shard")
        if bad is not None and data.dtype.kind == "f" and data.size:
            data = data.copy()
            data.reshape(-1)[0] = bad
        if self._quarantine and data.dtype.kind == "f" and \
                not onp.isfinite(data).all():
            return None
        if self._data_sh is not None:
            lo, _ = host_batch_rows(self._data_sh,
                                    (B,) + self._sample_shape)
            gdata = assemble_global(data, self._data_sh,
                                    (B,) + self._sample_shape, lo)
            glabel = assemble_global(labels, self._label_sh,
                                     (B,) + self._label_shape, lo)
            return NDArray(gdata), NDArray(glabel)
        from ..ndarray import array as _nd_array
        return _nd_array(data, ctx=_cpu()), _nd_array(labels, ctx=_cpu())

    def next(self):
        total = self.steps_per_epoch * self._epochs
        while self._step < total:
            epoch, step = divmod(self._step, self.steps_per_epoch)
            out = self._load_step(epoch, step)
            self._step += 1
            if out is None:                    # quarantined shard
                self.quarantined += 1
                self._obs_quarantined.inc()
                continue
            self._served += 1
            return out
        raise StopIteration

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def reset(self):
        self._step = 0

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"served": self._served, "quarantined": self.quarantined,
                "step_cursor": self._step,
                "steps_per_epoch": self.steps_per_epoch,
                "epochs": self._epochs}

    def __repr__(self):
        return (f"ShardedLoader(n={self._n}, batch={self.batch_size}, "
                f"steps/epoch={self.steps_per_epoch}, "
                f"cursor={self._step})")
