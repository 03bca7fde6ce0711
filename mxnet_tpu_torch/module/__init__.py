"""``mx.mod`` — the 1.x Module API (counterpart of
``mxnet_tpu/module/__init__.py``).

One Executor evaluates the symbol through the port's ``nd`` ops on the
module's context (``context=``, default the current context: the card
unless the caller asks for the CPU).  Batches from ``mx.io`` (host
arrays) are moved there as they are fed.  Multi-device data
parallelism is ``mxnet_tpu_torch.parallel``'s, not executor replicas.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .. import base as _base
from .. import initializer as _init_mod
from .. import metric as _metric
from .. import ndarray as nd
from .. import optimizer as _opt
from ..io import DataBatch, DataDesc
from ..ndarray import NDArray
from ..symbol import _scope

__all__ = ["BaseModule", "Module", "BucketingModule"]


class BaseModule:
    def __init__(self, logger=None):
        self.logger = logger or logging.getLogger()
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # ---- convenience API shared by Module/BucketingModule
    def score(self, eval_data, eval_metric, num_batch=None, reset=True,
              epoch=0):
        if reset:
            eval_data.reset()
        if isinstance(eval_metric, str):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, reset=True):
        if reset:
            eval_data.reset()
        outs = []
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            o = self.get_outputs()[0]
            if batch.pad:
                o = o[:o.shape[0] - batch.pad]
            outs.append(o.asnumpy())
        return nd.array(onp.concatenate(outs, axis=0))

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The classic training loop (MXNet's BaseModule.fit)."""
        if num_epoch is None:
            raise _base.MXNetError("fit needs num_epoch")
        if initializer is None:
            initializer = _init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if isinstance(eval_metric, str):
            eval_metric = _metric.create(eval_metric)
        validation_metric = validation_metric or eval_metric

        from ..callback import BatchEndParam
        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            train_data.reset()
            for nbatch, batch in enumerate(train_data):
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(params)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def install_monitor(self, mon):
        """Attach an mx.monitor.Monitor (parity: BaseModule
        .install_monitor → executor set_monitor_callback); the monitor
        observes every eager op output via the dispatcher hook."""
        mon.install()
        self._monitor = mon
        return mon


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _to_device(v, bound):
    """Batch array ``v`` (NDArray, tensor or numpy) as an NDArray on the
    device of the array ``bound`` it replaces."""
    if not isinstance(v, NDArray):
        v = nd.array(v, ctx="cpu")
    if bound is not None and v._t.device != bound._t.device:
        v = v.as_in_context(bound._t.device)
    return v


def _topo_nulls(symbol):
    from ..symbol import _topo
    return [n for n in _topo(symbol) if n._op == "null"]


class Module(BaseModule):
    """Single-symbol module (parity: python/mxnet/module/module.py)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, **kwargs):
        super().__init__(logger)
        if isinstance(context, (list, tuple)):
            context = context[0] if context else None
        self._context = context
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = set(fixed_param_names or [])
        args = symbol.list_arguments()
        self._param_names = [a for a in args
                             if a not in self._data_names
                             and a not in self._label_names]
        self._exec = None
        self._arg_params: Dict[str, NDArray] = {}
        self._aux_params: Dict[str, NDArray] = {}

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in (self._label_shapes or [])})
        shapes.update({k: tuple(v.shape)
                       for k, v in self._arg_params.items()})
        _, outs, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, outs))

    # ------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        if self.binded and not force_rebind:
            return
        norm = lambda ds: [d if isinstance(d, DataDesc) else DataDesc(*d)
                           for d in ds]
        self._data_shapes = norm(data_shapes)
        self._label_shapes = norm(label_shapes) if label_shapes else []
        self._for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        shapes = {d.name: d.shape
                  for d in self._data_shapes + self._label_shapes}
        names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()
        # explicit Variable(shape=...) attrs participate in shape resolution
        for n in _topo_nulls(self._symbol):
            if "__shape__" in n._attrs:
                shapes.setdefault(n._name, tuple(n._attrs["__shape__"]))
        for k, v in self._arg_params.items():
            shapes.setdefault(k, tuple(v.shape))
        try:
            # partial inference solves layer-parameter shapes (nnvm
            # InferShape parity) — auto-created weights need no explicit
            # shape here
            arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        except _base.MXNetError as e:
            raise _base.MXNetError(
                f"Module.bind cannot resolve shapes: {e} — give "
                "sym.Variable(shape=...) explicit shapes, or load params "
                "first (set_params / Module.load)")
        self._arg_shape = dict(zip(names, arg_shapes))
        self._arg_shape.update(dict(zip(aux_names, aux_shapes)))
        with _scope(self._context):
            self._bind_arrays(names, aux_names, aux_shapes, for_training,
                              inputs_need_grad)
        self.binded = True

    def _bind_arrays(self, names, aux_names, aux_shapes, for_training,
                     inputs_need_grad):
        args = {}
        grads = {}
        for n in names:
            shape = self._arg_shape[n]
            args[n] = self._arg_params.get(n, nd.zeros(shape))
            if for_training and (n in self._param_names
                                 or (inputs_need_grad
                                     and n in self._data_names)) \
                    and n not in self._fixed_param_names:
                grads[n] = nd.zeros(shape)
        # aux states bind at their declared init (moving_var = ones)
        if aux_names:
            defaults = None
            for n_name in aux_names:
                if n_name not in self._aux_params:
                    if defaults is None:
                        defaults = self._symbol.default_aux_arrays(
                            aux_shapes)
                    self._aux_params[n_name] = defaults[n_name]
                args[n_name] = self._aux_params[n_name]
        req = {n: ("write" if n in grads else "null") for n in args}
        self._exec = self._symbol.bind(ctx=self._context, args=args,
                                       args_grad=grads, grad_req=req)

    # ----------------------------------------------------------- params
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        initializer = initializer or _init_mod.Uniform(0.01)
        with _scope(self._context):
            for n in self._param_names:
                if arg_params and n in arg_params:
                    arr = arg_params[n]
                    arr = arr if isinstance(arr, NDArray) else nd.array(arr)
                elif n in self._arg_params:   # preloaded (Module.load)
                    arr = self._arg_params[n]
                else:
                    if arg_params and not allow_missing:
                        raise _base.MXNetError(f"missing param {n}")
                    arr = nd.zeros(self._arg_shape[n])
                    initializer(n, arr)
                self._arg_params[n] = arr
                with torch.no_grad():
                    self._exec.arg_dict[n]._t.copy_(arr._t)
            for n, arr in (aux_params or {}).items():
                if n in self._aux_params:
                    with torch.no_grad():
                        self._aux_params[n]._t.copy_(
                            arr._t if isinstance(arr, NDArray) else
                            torch.as_tensor(onp.asarray(arr)))
        self.params_initialized = True

    def get_params(self):
        return ({k: self._exec.arg_dict[k].copy()
                 for k in self._param_names}, dict(self._aux_params))

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    # -------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            # upstream Module defaults rescale_grad = 1/batch_size — loss
            # heads (SoftmaxOutput) emit batch-SUMMED gradients
            if "rescale_grad" not in params and self._data_shapes:
                params["rescale_grad"] = 1.0 / self._data_shapes[0].shape[0]
            optimizer = _opt.create(optimizer, **params)
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # ---------------------------------------------------------- compute
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self._for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        # host batches move to the bound arrays' device
        feed = {n: _to_device(v, self._exec.arg_dict.get(n))
                for n, v in feed.items()}
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        for i, n in enumerate(self._param_names):
            if n in self._fixed_param_names:
                continue
            g = self._exec.grad_dict.get(n)
            if g is None:
                continue
            w = self._exec.arg_dict[n]
            self._updater(i, g, w)

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------- checkpoint
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint as _save_ckpt
        arg_p, aux_p = self.get_params()
        _save_ckpt(prefix, epoch, self._symbol, arg_p, aux_p)
        if save_optimizer_states:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from ..model import load_checkpoint as _load_ckpt
        symbol, arg_params, aux_params = _load_ckpt(prefix, epoch)
        mod = Module(symbol, **kwargs)
        mod._preloaded = (arg_params, aux_params)
        mod._arg_params = arg_params
        mod._aux_params = aux_params
        if load_optimizer_states:
            mod._preloaded_states = f"{prefix}-{epoch:04d}.states"
        return mod


class BucketingModule(BaseModule):
    """Per-bucket executor cache sharing parameters (MXNet's
    bucketing_module.py; Sockeye's variable-length batching): each
    bucket key binds its own Module on the same context."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=None,
                 context=None, **kwargs):
        super().__init__(logger)
        self._context = context
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._buckets: Dict = {}
        self._curr_module: Optional[Module] = None
        self._curr_bucket_key = None
        self._kwargs = kwargs

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            self._buckets[bucket_key] = Module(
                sym, data_names=data_names, label_names=label_names,
                logger=self.logger, context=self._context)
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes,
                     getattr(self._curr_module, "_for_training", True))
            # share parameters with the master module
            if self._curr_module is not None \
                    and self._curr_module.params_initialized:
                arg_p, aux_p = self._curr_module.get_params()
                shared = {k: v for k, v in arg_p.items()
                          if k in mod._param_names}
                mod.init_params(arg_params=shared, aux_params=aux_p,
                                allow_missing=True, force_init=True)
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, *args, **kwargs):
        self._curr_module.init_params(*args, **kwargs)
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        self._curr_module.init_optimizer(*args, **kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_bucket_key)
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        # all buckets share params: push the update through the current one,
        # then propagate values to the others' executors lazily on switch
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_params(self):
        return self._curr_module.get_params()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)
