"""Trainer: binds parameters to an optimizer (counterpart of
``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` applies the optimizer to every parameter's
gradient buffer with ``rescale_grad = scale / batch_size``.  Parameters
are indexed in sorted key order, as in the reference.  The port trains
on one device, so there is no gradient reduction: ``kvstore`` may be
None, ``'device'`` or ``'local'``; a ``dist_*`` kvstore raises (multi-
GPU training is ROADMAP queue A6).
"""
from __future__ import annotations

from typing import List

from .. import base as _base
from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_ONE_DEVICE_KVSTORES = (None, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be list/dict/ParameterDict")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(f"invalid parameter {p!r}")
        if kvstore not in _ONE_DEVICE_KVSTORES:
            raise _base.MXNetError(
                f"kvstore {kvstore!r}: the port's Trainer runs on one "
                "device with no gradient reduction (None, 'device' or "
                "'local'); distributed training is ROADMAP queue A6")
        if update_on_kvstore:
            raise _base.MXNetError(
                "update_on_kvstore=True needs a kvstore server; the port "
                "updates locally (ROADMAP queue A6)")
        if compression_params is not None:
            raise _base.MXNetError("gradient compression needs a "
                                   "distributed kvstore (ROADMAP queue A6)")
        self._params: List[Parameter] = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise ValueError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """``allreduce_grads`` + ``update``, gradients scaled by
        ``1 / batch_size``.  With a loss scaler attached
        (``amp.init_trainer``) a step whose gradients are not finite is
        skipped: the parameters stay, the scale shrinks and
        ``skipped_steps`` counts it."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            if scaler.has_overflow(self._params):
                scaler.update_scale(skip=True)
                self._scale = getattr(self, "_amp_original_scale", 1.0) / \
                    scaler.loss_scale
                self.skipped_steps = getattr(self, "skipped_steps", 0) + 1
                return
            scaler.update_scale(skip=False)
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """One list-wise optimizer step over every parameter with a
        gradient (``Optimizer.update_multi``), as the reference's
        ``update`` compiles into one program."""
        indices, grads, datas = [], [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            try:
                data, grad = p.data(), p.grad()
            except _base.MXNetError:
                if ignore_stale_grad:
                    continue
                raise
            indices.append(i)
            grads.append(grad)
            datas.append(data)
        self._updaters[0](indices, grads, datas)

    def save_states(self, fname):
        """The optimizer's states and counts in the reference's format."""
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read())
