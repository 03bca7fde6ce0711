"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``;
MXNet's ``python/mxnet/gluon/data/dataset.py``)."""
from __future__ import annotations

from typing import Sequence

import numpy as onp

from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in
                              range(min(count, len(self)))])

    def sample(self, sampler):
        return _SampledDataset(self, sampler)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, data, sampler):
        self._data = data
        self._indices = list(sampler)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            if isinstance(a, NDArray):
                a = a.asnumpy()
            assert len(a) == self._length, "all arrays must be same length"
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file (parity: gluon RecordFileDataset)."""

    def __init__(self, filename):
        from ...recordio import IndexedRecordIO
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = IndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
