"""Mixed precision (counterpart of ``mxnet_tpu/amp/__init__.py``).

This slice ports the dynamic loss-scaling schedule, :class:`LossScaler`,
which ``parallel.ShardedTrainer(loss_scaler=...)`` runs on the device.
Autocast with float32 master weights is still to come.
"""
from __future__ import annotations

__all__ = ["LossScaler"]


class LossScaler:
    """Dynamic loss scaling (parity: contrib/amp/loss_scaler.py): the
    scale halves (by ``scale_factor``, never below 1) after a step with a
    non-finite gradient and grows by ``scale_factor`` after
    ``scale_window`` finite steps in a row."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def update_scale(self, skip: bool):
        if skip:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
