"""KVStore: key-value parameter/gradient store (counterpart of
``mxnet_tpu/kvstore/__init__.py``; parity: MXNet's src/kvstore/*).

One process holds one device, so the in-process types (``local``,
``device``, ``nccl``, ``tpu``) aggregate the values pushed in this
process.  The ``dist_*`` types then all-reduce the aggregate over every
process of the job (``torch.distributed``, after
``parallel.init_distributed``), summed as MXNet's ``dist_sync`` sums the
workers' pushes; ``dist_async`` applies every worker's pushed value as
its own update (no merge), in rank order on every process, so the
workers' copies stay equal.  ``update_on_kvstore`` (``set_optimizer``)
runs the optimizer on the aggregated gradient inside the store; 2-bit
gradient compression with per-(key, value) error feedback applies to
each pushed value before the reduction, as ``gradient_compression.cc``.
The ``KVStoreBase`` plugin registry is kept.

Row-sparse values: in one process, pushing ``RowSparseNDArray``
gradients to a store with an optimizer merges them compactly (their
unique rows) into the updater's lazy row update, as the reference's
``kvstore_local`` sparse push; ``row_sparse_pull`` gathers only the
rows asked for into a row-sparse ``out``.  Every other path reads a
row-sparse value's dense form, as the reference's ``_reduce`` does, and
so does a push that must sum over the processes of a ``dist_*`` job
(the reference's push never crosses processes there).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import base as _base
from ..ndarray.ndarray import NDArray
from ..resilience.faults import inject as _inject

__all__ = ["KVStore", "KVStoreBase", "create"]

_registry = _base.registry("kvstore")


class KVStoreBase:
    """Plugin base (parity: python/mxnet/kvstore/base.py)."""

    OPTIMIZER = "optimizer"

    @staticmethod
    def register(klass):
        _registry.register(klass.__name__)(klass)
        return klass

    def broadcast(self, key, value, out):
        raise NotImplementedError

    def pushpull(self, key, value, out=None):
        raise NotImplementedError

    @property
    def type(self):
        return type(self).__name__

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def is_capable(self, capability):
        return True


def _t(x) -> torch.Tensor:
    return x.tensor if isinstance(x, NDArray) else x


def _write(target, value: torch.Tensor):
    """``value`` into ``target`` in place: a row-sparse target becomes
    dense (every row present), keeping its handle."""
    from ..ndarray.sparse import RowSparseNDArray
    if isinstance(target, RowSparseNDArray):
        target._set_dense(value.detach().to(target._sp_data.device,
                                            copy=True))
    else:
        _t(target).copy_(value)


class KVStore(KVStoreBase):
    """The store behind every registered type (see the module
    docstring)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compression: Optional[dict] = None
        self._residuals: Dict = {}   # (key, value index) -> error feedback
        # fleet counters: push/pull traffic per kvstore type
        from ..observability.registry import default_registry
        _reg = default_registry()
        self._obs_push = _reg.counter("mxtpu_kvstore_push_total",
                                      help="kvstore push calls",
                                      type=kv_type)
        self._obs_pull = _reg.counter("mxtpu_kvstore_pull_total",
                                      help="kvstore pull calls",
                                      type=kv_type)

    # -- identity ---------------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        from ..parallel.distributed import rank
        return rank()

    @property
    def num_workers(self):
        from ..parallel.distributed import num_workers
        return num_workers()

    def _dist_group(self):
        """The world's group for a ``dist_*`` type in a job of more than
        one process, else None."""
        import torch.distributed as dist
        if not self._type.startswith("dist") or not dist.is_initialized() \
                or dist.get_world_size() == 1:
            return None
        return dist.group.WORLD

    # -- core ops ---------------------------------------------------------
    def init(self, key, value):
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            v = v[0] if isinstance(v, list) else v
            self._store[k] = NDArray(_t(v).detach().clone())

    def _reduce(self, k, vals: List) -> torch.Tensor:
        """Aggregate one key's pushed values (parity: Comm::Reduce): each
        compressed first when 2-bit compression is on, summed on the
        first value's device, then summed over the job's processes for a
        ``dist_*`` type."""
        from ..parallel import collectives
        dev = _t(vals[0]).device
        arrs = [_t(v).detach().to(dev) for v in vals]
        if self._compression and \
                str(self._compression.get("type", "none")) == "2bit":
            thr = float(self._compression.get("threshold", 0.5))
            arrs = [self._compress_2bit(k, i, a, thr)
                    for i, a in enumerate(arrs)]
        agg = arrs[0].clone() if len(arrs) == 1 else \
            torch.sum(torch.stack(arrs), dim=0)
        collectives.all_reduce_([agg], self._dist_group())
        return agg

    def _compress_2bit(self, key, idx, grad, threshold):
        """{-t, 0, +t} quantization with per-(key, value) error feedback
        (parity: src/kvstore/gradient_compression.cc 2-bit scheme)."""
        res = self._residuals.get((key, idx))
        g = grad if res is None else grad + res
        q = torch.where(g >= threshold, torch.full_like(g, threshold),
                        torch.where(g <= -threshold,
                                    torch.full_like(g, -threshold),
                                    torch.zeros_like(g)))
        self._residuals[(key, idx)] = g - q
        return q

    def _apply_async(self, k, vals):
        """``dist_async``: every pushed value is its own update; across
        processes every worker's values, in rank order."""
        from ..parallel import collectives
        group = self._dist_group()
        for x in vals:
            for g in collectives.all_gather(_t(x).detach(), group):
                self._updater(k, NDArray(g), self._store[k])

    def push(self, key, value, priority=0):
        from ..ndarray.sparse import RowSparseNDArray, merge_rows
        _inject("kvstore.push")
        self._obs_push.inc()
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            vals = v if isinstance(v, list) else [v]
            if k not in self._store:
                raise _base.MXNetError(f"key {k} not initialized")
            if self._updater is not None and not self._compression and \
                    self._type.startswith("dist_async"):
                self._apply_async(k, vals)
                continue
            if self._updater is not None and not self._compression and \
                    self._dist_group() is None and \
                    all(isinstance(x, RowSparseNDArray) for x in vals):
                # compact into the updater's lazy row update
                agg_rs = vals[0]
                if len(vals) > 1:
                    dev = vals[0]._sp_data.device
                    data, idx = merge_rows(
                        [x._sp_data.to(dev) for x in vals],
                        [x._sp_indices.to(dev) for x in vals])
                    agg_rs = RowSparseNDArray.from_components(
                        data, idx, vals[0].shape)
                self._updater(k, agg_rs, self._store[k])
                continue
            agg = self._reduce(k, vals)
            if self._updater is not None:
                # update_on_kvstore: run optimizer on aggregated grad
                self._updater(k, NDArray(agg), self._store[k])
            else:
                self._store[k] = NDArray(agg)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        _inject("kvstore.pull")
        self._obs_pull.inc()
        keys, outs = _normalize(key, out)
        for k, o in zip(keys, outs):
            targets = o if isinstance(o, list) else [o]
            src = _t(self._store[k])
            with torch.no_grad():
                for t in targets:
                    _write(t, src)

    def pushpull(self, key, value, out=None, priority=0):
        """Fused push+pull: ONE reduce per key (upstream
        KVStore::PushPull), store updated per push semantics, aggregate
        broadcast to ``out``."""
        keys, values = _normalize(key, value)
        outs = _normalize(key, out)[1] if out is not None else \
            [None] * len(keys)
        for k, v, o in zip(keys, values, outs):
            vals = v if isinstance(v, list) else [v]
            agg = self._reduce(k, vals)
            if k not in self._store:
                raise _base.MXNetError(f"key {k} not initialized")
            if self._updater is not None:
                self._updater(k, NDArray(agg), self._store[k])
                agg = _t(self._store[k])     # pull the updated weight
            else:
                self._store[k] = NDArray(agg)
            if o is not None:
                targets = o if isinstance(o, list) else [o]
                with torch.no_grad():
                    for t in targets:
                        _write(t, agg)

    def broadcast(self, key, value, out, priority=0):
        """``value`` of the job's rank 0 into the store and ``out`` on
        every process (MXNet's initial broadcast of the weights)."""
        from ..parallel import collectives
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            v = v[0] if isinstance(v, list) else v
            t = _t(v).detach().clone()
            collectives.broadcast_([t], 0, self._dist_group())
            self._store[k] = NDArray(t)
        self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows of a key (parity: MXNet's
        ``KVStore::PullRowSparse``, the unique-key gather of
        ``kvstore_local.cc``): a ``RowSparseNDArray`` ``out`` receives
        the unique ids, ascending, and their rows, gathered on the store
        with ``index_select``; its dense form is never built.  An id out
        of range raises.  A dense ``out`` (or no ``row_ids``) takes a
        whole pull."""
        from ..ndarray.sparse import RowSparseNDArray
        if row_ids is None:
            self.pull(key, out=out, priority=priority)
            return
        keys, outs = _normalize(key, out)
        rows_list = row_ids if isinstance(row_ids, list) else \
            [row_ids] * len(keys)
        for k, o, rids in zip(keys, outs, rows_list):
            targets = o if isinstance(o, list) else [o]
            src = _t(self._store[k])
            ids = _t(rids) if isinstance(rids, (NDArray, torch.Tensor)) \
                else torch.as_tensor(rids)
            uniq = torch.unique(ids.detach().reshape(-1).to(
                device=src.device, dtype=torch.int64), sorted=True)
            if uniq.numel():
                lo, hi = int(uniq[0]), int(uniq[-1])
                if lo < 0 or hi >= src.shape[0]:
                    raise _base.MXNetError(
                        f"row_sparse_pull row_ids out of range for key "
                        f"{k}: [{lo}, {hi}] vs {src.shape[0]} rows")
            rows = src.index_select(0, uniq)
            for t in targets:
                if isinstance(t, RowSparseNDArray):
                    dev = t._sp_data.device
                    t._sp_shape = tuple(src.shape)
                    t._set_components(rows.to(dev, copy=True),
                                      uniq.to(dev))
                else:
                    with torch.no_grad():
                        _write(t, src)

    # -- optimizer --------------------------------------------------------
    def set_optimizer(self, optimizer):
        from .. import optimizer as opt_mod
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    @property
    def updater(self):
        return self._updater

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression with error feedback (parity:
        src/kvstore/gradient_compression.cc): each pushed value is
        quantized to {-t, 0, +t} before the reduction and the residual
        kept for the next push; {'type': 'none'} disables."""
        params = dict(compression_params or {})
        ctype = str(params.get("type", "none"))
        if ctype not in ("none", "2bit"):
            raise _base.MXNetError(
                f"unsupported gradient compression type {ctype!r} "
                "(supported: 'none', '2bit')")
        self._compression = params if ctype != "none" else None
        self._residuals.clear()

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise _base.MXNetError("kvstore has no optimizer")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise _base.MXNetError("kvstore has no optimizer")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


for _t_name in ("local", "device", "nccl", "tpu", "dist_sync", "dist_async",
                "dist_sync_device", "dist_async_device", "dist"):
    _registry.register(_t_name)(KVStore)


def create(name="local") -> KVStore:
    """Parity: mx.kv.create('device'|'nccl'|'dist_sync'|...)."""
    cls = _registry.get(name)
    if cls is KVStore:
        return KVStore(name)
    return cls()
