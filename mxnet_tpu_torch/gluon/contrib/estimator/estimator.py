"""``Estimator`` (counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``): the Keras-style fit
loop over the port's ``Trainer``, ``metric``, ``loss`` and
``gluon.data``, driven by event handlers.

A batch (a ``(data, label)`` pair or a ``DataBatch``) moves to
``context`` where one is given, else to the device of the net's
parameters, else to the current context: the port's loaders give
batches on ``mx.cpu()``, and a net on the card takes its inputs there
(its deferred parameters then settle there)."""
from __future__ import annotations

import copy

from .... import autograd
from .... import metric as _metric_mod
from ....context import current_context
from ....ndarray.ndarray import NDArray
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            GradientUpdateHandler, LoggingHandler,
                            MetricHandler, StoppingHandler, TrainBegin,
                            TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


class _LossMetric(_metric_mod.EvalMetric):
    """The running mean of the loss (the estimator's 'loss' metric)."""

    def __init__(self, name="loss"):
        super().__init__(name)

    def update(self, _, losses):
        for l in losses if isinstance(losses, (list, tuple)) else [losses]:
            arr = l.asnumpy()
            self.sum_metric += float(arr.sum())
            self.num_inst += arr.size


class Estimator:
    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 initializer=None, trainer=None, context=None,
                 evaluation_loss=None):
        self.net = net
        self.loss = loss
        self.stop_training = False
        self.context = context

        def norm_metrics(ms):
            if ms is None:
                return []
            ms = ms if isinstance(ms, (list, tuple)) else [ms]
            return [m if isinstance(m, _metric_mod.EvalMetric)
                    else _metric_mod.create(m) for m in ms]

        self.train_metrics = norm_metrics(train_metrics) or \
            [_metric_mod.Accuracy()]
        # a deep copy keeps the constructor's settings (TopKAccuracy(k))
        self.val_metrics = norm_metrics(val_metrics) or \
            [copy.deepcopy(m) for m in self.train_metrics]
        self.train_loss_metric = _LossMetric("train_loss")
        self.val_loss_metric = _LossMetric("val_loss")

        if initializer is not None:
            self.net.initialize(initializer)
        self.trainer = trainer or Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.001})

    # ------------------------------------------------------------------
    def evaluate(self, val_data, batch_axis=0):
        for m in self.val_metrics:
            m.reset()
        self.val_loss_metric.reset()
        for batch in val_data:
            data, label = self._unpack(batch)
            pred = self.net(data)
            loss = self.loss(pred, label)
            self.val_loss_metric.update(None, loss)
            for m in self.val_metrics:
                m.update([label], [pred])
        return [self.val_loss_metric] + list(self.val_metrics)

    def _device(self):
        """Where batches go: ``context``, else the net's parameters'
        device, else (parameters still waiting for their first batch)
        the current context's."""
        if self.context is not None:
            return self.context[0] if isinstance(self.context, (list, tuple)) \
                else self.context
        dev = self.net.device
        return dev if dev is not None else current_context()

    def _unpack(self, batch):
        if isinstance(batch, (list, tuple)):
            data, label = batch[0], batch[1]
        else:
            data, label = batch.data[0], batch.label[0]
        dev = self._device()
        if dev is not None:
            data, label = (x.as_in_context(dev) if isinstance(x, NDArray)
                           else x for x in (data, label))
        return data, label

    # ------------------------------------------------------------------
    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        if epochs is None and batches is None:
            raise ValueError(
                "fit() needs a stopping criterion: pass epochs or batches")

        handlers = list(event_handlers or [])
        handlers.append(StoppingHandler(epochs, batches))
        if not any(isinstance(h, GradientUpdateHandler) for h in handlers):
            handlers.append(GradientUpdateHandler())
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler())
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler())
        if val_data is not None and \
                not any(isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        # lower priority fires first (validation at -1000, so the metrics
        # exist before the early-stop and checkpoint handlers read them)
        handlers.sort(key=lambda h: getattr(h, "priority", 0))

        def fire(event, cls):
            for h in handlers:
                if isinstance(h, cls):
                    getattr(h, event)(self)

        self.stop_training = False
        fire("train_begin", TrainBegin)
        try:
            while not self.stop_training:
                fire("epoch_begin", EpochBegin)
                for batch in train_data:
                    if self.stop_training:
                        break
                    fire("batch_begin", BatchBegin)
                    data, label = self._unpack(batch)
                    with autograd.record():
                        pred = self.net(data)
                        loss = self.loss(pred, label)
                    loss.backward()
                    # the optimizer step and the metrics are handlers
                    # (GradientUpdateHandler -2000, MetricHandler -1000)
                    self._batch_size = data.shape[batch_axis]
                    self._batch_label = label
                    self._batch_pred = pred
                    self._batch_loss = loss
                    fire("batch_end", BatchEnd)
                fire("epoch_end", EpochEnd)
                if hasattr(train_data, "reset"):
                    train_data.reset()
        finally:
            # the loss holds its whole graph: drop the last batch's arrays
            self._batch_pred = self._batch_label = self._batch_loss = None
        fire("train_end", TrainEnd)
        return self
