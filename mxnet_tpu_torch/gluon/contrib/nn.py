"""``gluon.contrib.nn`` (counterpart of ``mxnet_tpu/gluon/contrib/nn.py``):
``Concurrent`` and ``HybridConcurrent``, and ``Identity`` and
``SyncBatchNorm`` re-exported from ``gluon.nn`` under upstream's import
path."""
from __future__ import annotations

import torch

from ..block import HybridBlock
from ..nn import Identity, SyncBatchNorm  # noqa: F401  (upstream path)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SyncBatchNorm"]


class Concurrent(HybridBlock):
    """Runs its children on the same input and concatenates their
    outputs along ``axis`` (Inception-style branches).  The children are
    read from the module tree at every call, so a child swapped by
    ``register_child`` (``quantize_net``) is the one that runs."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block, str(len(self._modules)))
        return self

    @property
    def _layers(self):
        return list(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return self._layers[i]

    def forward(self, x):
        return torch.cat([blk(x) for blk in self._modules.values()],
                         dim=self.axis)


class HybridConcurrent(Concurrent):
    """``Concurrent``: every block here hybridizes."""
