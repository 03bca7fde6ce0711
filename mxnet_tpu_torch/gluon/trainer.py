"""Trainer: binds parameters to an optimizer (counterpart of
``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` applies the optimizer to every parameter's
gradient buffer with ``rescale_grad = scale / batch_size``.  Parameters
are indexed in sorted key order, as in the reference.  A process holds
one device, so an in-process kvstore (None, ``'device'``, ``'local'``,
``'nccl'``) has nothing to reduce.  A ``dist_*`` kvstore
(:mod:`~mxnet_tpu_torch.kvstore`) sums each gradient over the job's
processes in ``allreduce_grads`` (MXNet's ``dist_sync``: the workers'
gradients summed, so ``batch_size`` is the global batch), after a first
``broadcast`` of rank 0's weights.  ``update_on_kvstore=True`` runs the
optimizer inside the store on the aggregated gradient and pulls the
weights back; ``compression_params`` sets the store's 2-bit gradient
compression.
"""
from __future__ import annotations

from typing import List

from .. import base as _base
from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict, is_initialized

__all__ = ["Trainer"]

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
        if isinstance(kvstore, str):
            kvs_mod._registry.get(kvstore)     # an unknown type raises
        self._kvstore_str = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._compression_params = compression_params
        self._kvstore = None
        self._kv_initialized = False
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
        if isinstance(kvstore, str) and kvstore.startswith("dist"):
            # every process starts from rank 0's weights before its first
            # forward, not at the first step after it
            self._init_kvstore()

    def _init_kvstore(self):
        """Create the kvstore (the reference's ``_init_kvstore``; at the
        first step, or at construction for a ``dist_*`` type): a
        ``dist_*`` store starts every process from rank 0's weights."""
        kv = self._kvstore_str
        if kv is None:
            self._update_on_kvstore = False
        else:
            if not isinstance(kv, kvs_mod.KVStoreBase):
                kv = kvs_mod.create(kv)
            self._kvstore = kv
            if self._update_on_kvstore is None:
                self._update_on_kvstore = False
            if self._compression_params is not None:
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                if not is_initialized(p.tensor):
                    continue
                if self._is_dist():
                    kv.broadcast(i, p.data(), out=p.data())
                else:
                    kv.init(i, p.data())
        self._kv_initialized = True

    def _is_dist(self) -> bool:
        return self._kvstore is not None and \
            str(self._kvstore.type).startswith("dist")

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
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
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
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """Through the kvstore: with ``update_on_kvstore`` push every
        gradient (the store updates) and pull the weight; else, for a
        ``dist_*`` store, push and pull every gradient (summed over the
        processes).  Nothing on one device."""
        kv = self._kvstore
        if kv is None or not (self._update_on_kvstore or self._is_dist()):
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if self._update_on_kvstore:
                kv.push(i, p.grad())
                kv.pull(i, p.data())
            else:
                kv.pushpull(i, p.grad(), out=p.grad())

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """One list-wise optimizer step over every parameter with a
        gradient (``Optimizer.update_multi``), as the reference's
        ``update`` compiles into one program; a row-sparse gradient goes
        to the updater's lazy row update (``Updater``), not through the
        list; nothing when the kvstore updated the weights."""
        if self._update_on_kvstore:
            return
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
        """The optimizer's states and counts in the reference's format
        (the kvstore's under ``update_on_kvstore``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states())

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read())
