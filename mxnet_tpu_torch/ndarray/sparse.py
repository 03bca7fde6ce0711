"""Sparse NDArray types (counterpart of ``mxnet_tpu/ndarray/sparse.py``;
parity: python/mxnet/ndarray/sparse.py).

Sparse is a *storage* form with explicit dense boundaries, as in MXNet:
the compact components (``data``/``indices``/``indptr``) live as tensors
on the array's device, the dense value is built on its first use and
cached, and reading ``shape``, ``dtype``, ``size``, ``ndim``, ``stype``
or ``context`` never builds it.  ``RowSparseNDArray`` is the storage of
sparse gradients (``Embedding(sparse_grad=True)``, a parameter's
``grad_stype='row_sparse'``): it drives the optimizers' lazy row-wise
update (``optimizer.Updater``) and the kvstore's ``row_sparse_pull``
without ever allocating its ``(rows, ...)`` dense form.

``dot(csr, dense)`` and ``dot(csr, dense, transpose_a=True)`` are a
gather and a segment sum in torch ops (``index_select``, a product and
``index_add``), as the reference's are in ``jnp`` (no Pallas kernel
there, so none here); they are differentiable with respect to the
dense operand.  On the card the segment sum is ``index_add`` over
atomic float adds: its sums are not bit-deterministic from run to run
(the order of the adds varies), and agree with the CPU's to float32
rounding (``tests/test_torch_cuda.py`` holds them within 1e-5).  The
merge of two row-sparse arrays (``sparse_add``, tied lookups, a
kvstore's aggregate) is the same segment sum over ``torch.unique``'s
inverse.  Index components are int64 (MXNet's aux type; the reference
keeps int32, jax's default).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import base as _base
from ..base import torch_dtype
from ..context import Context, resolve_device
from .ndarray import NDArray, _numpy_dtype

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix",
           "row_sparse_array", "cast_storage", "zeros", "empty", "dot",
           "BaseSparseNDArray", "sparse_add", "retain"]


def _tensor(x, device=None, dtype=None):
    """``x`` (NDArray, tensor, numpy array or list) as a tensor on
    ``device`` (default: where it is, else the current context)."""
    if isinstance(x, NDArray):
        x = x._t
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = np.asarray(x)
        if dtype is None and a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, order="C"))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def _index(x, device):
    return _tensor(x, device).to(torch.int64).reshape(-1)


class BaseSparseNDArray(NDArray):
    """Common base: the dense value is built from the components on its
    first use (``_t``) and cached in ``_data``."""

    __slots__ = ("_data",)

    def _materialize(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def _t(self):
        if self._data is None:
            self._data = self._materialize()
        return self._data

    @_t.setter
    def _t(self, value):
        # an in-place op on a sparse array rebinds its dense value
        self._set_dense(value)

    # metadata from the components: reading the dense form here would
    # build (and cache) the whole buffer on an incidental inspection
    @property
    def shape(self):
        return tuple(self._sp_shape)

    @property
    def dtype(self):
        return _numpy_dtype(self._sp_data.dtype)

    @property
    def size(self):
        return int(np.prod(self._sp_shape, dtype=np.int64))

    @property
    def ndim(self):
        return len(self._sp_shape)

    @property
    def context(self):
        return Context(self._sp_data.device)

    ctx = context
    device = context

    @property
    def stype(self):
        raise NotImplementedError

    def tostype(self, stype: str):
        if stype == "default":
            return NDArray(self._t)
        if stype == self.stype:
            return self
        return cast_storage(self, stype)

    def todense(self) -> NDArray:
        return NDArray(self._t)

    def asscipy(self):
        raise _base.MXNetError("scipy interop not available")


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (parity: mx.nd.sparse.CSRNDArray)."""

    __slots__ = ("_sp_data", "_sp_indices", "_sp_indptr", "_sp_shape")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        dev = _where(data, ctx)
        self._sp_data = _tensor(data, dev)
        self._sp_indices = _index(indices, dev)
        self._sp_indptr = _index(indptr, dev)
        self._sp_shape = tuple(int(s) for s in shape)
        self._data = None
        self._alias = False

    def _materialize(self):
        return _csr_to_dense(self._sp_data, self._sp_indices,
                             self._sp_indptr, self._sp_shape)

    def _set_dense(self, full):
        c = _dense_to_csr(full.detach())
        self._sp_data, self._sp_indices, self._sp_indptr = \
            c._sp_data, c._sp_indices, c._sp_indptr
        self._sp_shape = tuple(full.shape)
        self._data = full

    @property
    def stype(self):
        return "csr"

    @property
    def data(self) -> NDArray:
        return NDArray(self._sp_data)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._sp_indices)

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._sp_indptr)

    def copy(self):
        return CSRNDArray(self._sp_data.clone(), self._sp_indices.clone(),
                          self._sp_indptr.clone(), self._sp_shape)

    def __repr__(self):
        return (f"<CSRNDArray {self._sp_shape} "
                f"nnz={int(self._sp_data.shape[0])}>")


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse tensor: a subset of rows is stored (parity:
    mx.nd.sparse.RowSparseNDArray; the storage type of sparse
    gradients).  ``indices`` are unique and ascending."""

    __slots__ = ("_sp_data", "_sp_indices", "_sp_shape")

    def __init__(self, data, indices, shape, ctx=None):
        dev = _where(data, ctx)
        self._sp_data = _tensor(data, dev)
        self._sp_indices = _index(indices, dev)
        self._sp_shape = tuple(int(s) for s in shape)
        self._data = None
        self._alias = False

    def _materialize(self):
        out = torch.zeros(self._sp_shape, dtype=self._sp_data.dtype,
                          device=self._sp_data.device)
        if self._sp_indices.numel():
            out.index_copy_(0, self._sp_indices, self._sp_data)
        return out

    def _set_components(self, data, indices):
        """Rebind the compact payload in place (``row_sparse_pull``, a
        gradient written by ``backward``, ``zero_grad``); drops any
        cached dense form, so held handles see the new value."""
        self._sp_data = data
        self._sp_indices = indices.to(torch.int64)
        self._data = None

    def _set_dense(self, full):
        """Rebind from a dense value in place, every row present (a dense
        gradient written into a row-sparse buffer), keeping held handles
        and the declared stype valid."""
        self._sp_shape = tuple(full.shape)
        self._sp_indices = torch.arange(full.shape[0], device=full.device)
        self._sp_data = full
        self._data = full

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self) -> NDArray:
        return NDArray(self._sp_data)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._sp_indices)

    def copy(self):
        return RowSparseNDArray.from_components(
            self._sp_data.clone(), self._sp_indices.clone(), self._sp_shape)

    def __repr__(self):
        return (f"<RowSparseNDArray {self._sp_shape} "
                f"rows={int(self._sp_indices.shape[0])}>")

    @classmethod
    def from_components(cls, data, indices, shape, ctx=None):
        """Build from tensors without a host round trip (the gradient
        path's constructor: it stays compact until its dense form is
        asked for)."""
        obj = cls.__new__(cls)
        dev = _where(data, ctx)
        obj._sp_data = _tensor(data, dev)
        obj._sp_indices = _index(indices, dev)
        obj._sp_shape = tuple(int(s) for s in shape)
        obj._data = None
        obj._alias = False
        return obj


def _where(data, ctx):
    """The device the components go to: ``ctx`` when given, else the
    device of a tensor or NDArray ``data``, else the current context."""
    if ctx is not None:
        return resolve_device(ctx)
    if isinstance(data, NDArray):
        return data._sp_data.device if isinstance(
            data, BaseSparseNDArray) else data._t.device
    if isinstance(data, torch.Tensor):
        return data.device
    return resolve_device(None)


# ------------------------------------------------------------ row merges

def merge_rows(datas, indices, n_rows=None):
    """The row-sparse sum of ``(data, indices)`` pairs: the unique rows,
    ascending, each with its rows' sum (a segment sum over
    ``torch.unique``'s inverse)."""
    idx = torch.cat([i.to(torch.int64) for i in indices])
    vals = torch.cat(list(datas), dim=0)
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    out = torch.zeros((uniq.numel(),) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, inv, vals), uniq


def from_torch_grad(g: torch.Tensor):
    """(data, indices) of a torch sparse COO gradient over rows (what
    ``F.embedding(..., sparse=True)`` gives), coalesced: unique rows
    with their summed values."""
    g = g.coalesce()
    return g.values(), g.indices()[0]


def to_torch_grad(rsp: RowSparseNDArray) -> torch.Tensor:
    """``rsp`` as a torch sparse COO tensor (a leaf's ``.grad`` that
    torch's autograd adds onto)."""
    return torch.sparse_coo_tensor(rsp._sp_indices[None], rsp._sp_data,
                                   rsp._sp_shape, is_coalesced=True,
                                   check_invariants=False)


# -------------------------------------------------------------- helpers

def _csr_row_ids(indptr, nnz):
    """The row of each stored entry, from ``indptr``."""
    n_rows = indptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), indptr.diff(),
        output_size=nnz)


def _csr_to_dense(data, indices, indptr, shape):
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    nnz = data.shape[0]
    if nnz:
        out[_csr_row_ids(indptr, nnz), indices] = data
    return out


def _dense_to_csr(dense: torch.Tensor, ctx=None) -> CSRNDArray:
    if dense.dim() != 2:
        raise _base.MXNetError("csr storage requires 2-D")
    mask = dense != 0
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                    device=dense.device),
                        mask.sum(dim=1).cumsum(0)])
    indices = mask.nonzero()[:, 1]
    return CSRNDArray(dense[mask], indices, indptr, tuple(dense.shape),
                      ctx=ctx)


def _dense_to_rsp(dense: torch.Tensor, ctx=None) -> RowSparseNDArray:
    flat = (dense != 0).reshape(dense.shape[0], -1)
    nz = flat.any(dim=1).nonzero().reshape(-1)
    return RowSparseNDArray.from_components(
        dense.index_select(0, nz), nz, tuple(dense.shape), ctx=ctx)


def _dense_of(arr) -> torch.Tensor:
    if isinstance(arr, NDArray):
        return arr._t.detach()
    return torch.as_tensor(np.asarray(arr, dtype=np.float32))


# ----------------------------------------------------------------- factory

def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """A CSRNDArray from ``(data, indices, indptr)`` or a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        dev = _where(data, ctx)
        data = _tensor(data, dev, None if dtype is None
                       else torch_dtype(dtype))
        return CSRNDArray(data, indices, indptr, shape, ctx=dev)
    dense = _dense_of(arg1)
    return _dense_to_csr(dense.to(_where(arg1, ctx)))


def row_sparse_array(arg1, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """A RowSparseNDArray from ``(data, indices)`` or a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        dev = _where(data, ctx)
        data = _tensor(data, dev, None if dtype is None
                       else torch_dtype(dtype))
        return RowSparseNDArray(data, indices, shape, ctx=dev)
    dense = _dense_of(arg1)
    return _dense_to_rsp(dense.to(_where(arg1, ctx)))


def cast_storage(arr: NDArray, stype: str):
    """Convert between storage types (parity: mx.nd.cast_storage), on the
    array's device."""
    if stype == "default":
        return NDArray(arr._t.detach())
    dense = arr._t.detach()
    if stype == "csr":
        return _dense_to_csr(dense)
    if stype == "row_sparse":
        return _dense_to_rsp(dense)
    raise _base.MXNetError(f"unknown stype {stype!r}")


def zeros(stype, shape, ctx=None, dtype="float32"):
    dt = torch_dtype(dtype)
    dev = resolve_device(ctx)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int64, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                      device=dev), shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int64, device=dev), shape)
    from .ndarray import zeros as dzeros
    return dzeros(shape, ctx=ctx, dtype=dtype)


def empty(stype, shape, ctx=None, dtype="float32"):
    return zeros(stype, shape, ctx, dtype)


# --------------------------------------------------------------- operators

def dot(lhs, rhs, transpose_a=False, transpose_b=False) -> NDArray:
    """Sparse-aware dot.  csr · dense (and csrᵀ · dense, the gradient and
    embedding-bag direction) gather the dense rows and sum them by
    segment, without densifying the csr side, dispatched through
    ``invoke`` so the dense operand gets autograd's pullback (the csr
    features are data, the dense operand the parameter).  Everything
    else goes through the dense ``nd.dot``."""
    from . import ops as _ops
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) and \
            not isinstance(rhs, BaseSparseNDArray):
        data, indices = lhs._sp_data, lhs._sp_indices
        n_rows, n_cols = lhs._sp_shape
        # an empty csr takes the same path (an empty gather, a zero
        # sum), so the output is on the graph all the same
        rows = _csr_row_ids(lhs._sp_indptr, data.shape[0])

        def f(r):
            if transpose_b:
                r = r.t()
            d = data.to(torch.promote_types(data.dtype, r.dtype))
            if transpose_a:
                # outᵀ[j] = Σ_{k: col(k) = j} data[k] * r[row(k)]
                gathered = r.index_select(0, rows) * d[:, None]
                seg, n = indices, n_cols
            else:
                gathered = r.index_select(0, indices) * d[:, None]
                seg, n = rows, n_rows
            out = torch.zeros((n, gathered.shape[1]), dtype=gathered.dtype,
                              device=gathered.device)
            return out.index_add(0, seg, gathered)

        return _ops.invoke("sparse_dot", f, [rhs])
    lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return _ops.dot(lhs, rhs, transpose_a=transpose_a,
                    transpose_b=transpose_b)


def sparse_add(lhs, rhs):
    """Elementwise add; RowSparse + RowSparse stays compact (the merged
    unique rows), anything else goes dense."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray) and \
            lhs._sp_shape == rhs._sp_shape:
        data, idx = merge_rows([lhs._sp_data, rhs._sp_data],
                               [lhs._sp_indices, rhs._sp_indices])
        return RowSparseNDArray.from_components(data, idx, lhs._sp_shape)
    from . import ops as _ops
    lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return _ops.add(lhs, rhs)


def retain(data: RowSparseNDArray, indices) -> RowSparseNDArray:
    """Keep only the requested rows (parity: mx.nd.sparse.retain)."""
    have = data._sp_indices
    want = _index(indices, have.device)
    keep = torch.isin(have, want).nonzero().reshape(-1)
    return RowSparseNDArray.from_components(
        data._sp_data.index_select(0, keep), have.index_select(0, keep),
        data._sp_shape)
