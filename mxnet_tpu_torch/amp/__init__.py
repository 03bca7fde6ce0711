"""Mixed precision (counterpart of ``mxnet_tpu/amp/__init__.py``).

This slice ports the dynamic loss-scaling schedule, :class:`LossScaler`,
which ``parallel.ShardedTrainer(loss_scaler=...)`` runs on the device,
and the guarded ``gluon.Trainer`` step behind :func:`init_trainer` /
:func:`scale_loss`.  Autocast with float32 master weights is still to
come.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

from ..base import MXNetError

__all__ = ["LossScaler", "init_trainer", "scale_loss"]


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

    def has_overflow(self, params) -> bool:
        """Whether any gradient of ``params`` (gluon Parameter handles) is
        not finite; one host read for all of them."""
        flags = [torch.isfinite(p.grad()._t).all() for p in params
                 if p.grad_req != "null"]
        return bool(flags) and not bool(torch.stack(flags).all())

    def update_scale(self, skip: bool):
        if skip:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0


def init_trainer(trainer, loss_scaler=None):
    """Attach a LossScaler to a trainer.  A ``gluon.Trainer`` consults it
    in ``step()``: an overflowed step is skipped and the scale shrinks.
    A ``ShardedTrainer`` runs its schedule on the device, so it must be
    attached before the first ``build()``/``step()``."""
    scaler = loss_scaler or LossScaler()
    if hasattr(trainer, "_loss_scaler"):         # ShardedTrainer
        if trainer._built:
            raise MXNetError("attach the loss scaler before the "
                             "ShardedTrainer's first build()/step()")
        trainer._loss_scaler = scaler
    else:
        trainer._amp_loss_scaler = scaler
        trainer._amp_original_scale = getattr(trainer, "_scale", 1.0)
    return trainer


_warned_no_scaler = False


def _warn_no_scaler(fn_name: str):
    global _warned_no_scaler
    if not _warned_no_scaler:
        _warned_no_scaler = True
        warnings.warn(
            f"amp.{fn_name} called on a trainer with no LossScaler "
            "attached: this is a no-op (the loss is NOT being scaled). "
            "Call amp.init_trainer(trainer) first.", FutureWarning,
            stacklevel=3)


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Scale the loss before backward; the gluon Trainer's next step
    divides the gradients by the scale.  A ShardedTrainer scales on the
    device, so its loss passes unchanged."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        if getattr(trainer, "_loss_scaler", None) is None:
            _warn_no_scaler("scale_loss")
        yield loss
        return
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale
    trainer._scale = getattr(trainer, "_amp_original_scale", 1.0) / \
        scaler.loss_scale
