"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``): each
metric reads labels and predictions on the host as numpy arrays, from
NDArrays, torch tensors or anything numpy takes."""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as onp
import torch

from . import base as _base
from .ndarray import NDArray

_registry = _base.registry("metric")
register = _registry.register

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "Perplexity", "PearsonCorrelation",
           "Loss", "CompositeEvalMetric", "CustomMetric", "create", "np"]


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return onp.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def _update(self, metric, n=1):
        self.sum_metric += metric
        self.num_inst += n
        self.global_sum_metric += metric
        self.global_num_inst += n

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def __str__(self):
        return f"EvalMetric: {dict([self.get()])}"


@register("acc")
@register()
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(onp.int64).flatten()
            label = label.astype(onp.int64).flatten()
            self._update((pred == label).sum(), len(label))


@register("top_k_accuracy")
@register()
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(onp.int64)
            topk = onp.argsort(pred, axis=-1)[:, -self.top_k:]
            hit = (topk == label[:, None]).any(axis=-1)
            self._update(hit.sum(), len(label))


@register()
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self._tp = self._fp = self._fn = 0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(onp.int64).flatten()
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1)
            else:
                pred = (pred.flatten() > 0.5).astype(onp.int64)
            pred = pred.flatten()
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            prec = self._tp / max(self._tp + self._fp, 1)
            rec = self._tp / max(self._tp + self._fn, 1)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register()
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self._cm = onp.zeros((2, 2))

    def reset(self):
        super().reset()
        self._cm = onp.zeros((2, 2))

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(onp.int64).flatten()
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1)
            else:
                pred = (pred.flatten() > 0.5).astype(onp.int64)
            for t, p in zip(label, pred.flatten()):
                self._cm[t, p] += 1
            tn, fp = self._cm[0]
            fn, tp = self._cm[1]
            denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            self.sum_metric = ((tp * tn - fp * fn) / denom) if denom else 0.0
            self.num_inst = 1


@register()
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            self._update(onp.abs(label - pred.reshape(label.shape)).mean()
                         * len(label), len(label))


@register()
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            self._update(((label - pred.reshape(label.shape)) ** 2).mean()
                         * len(label), len(label))


@register()
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register("ce")
@register()
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(onp.int64).flatten()
            pred = _as_numpy(pred)
            prob = pred[onp.arange(len(label)), label]
            self._update((-onp.log(prob + self.eps)).sum(), len(label))


@register()
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(onp.int64).flatten()
            pred = _as_numpy(pred).reshape(len(label), -1)
            mask = onp.ones_like(label, dtype=bool)
            if self.ignore_label is not None:
                mask = label != self.ignore_label
            prob = pred[onp.arange(len(label)), label]
            self._update((-onp.log(prob[mask] + self.eps)).sum(),
                         int(mask.sum()))

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register()
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels = []
        self._preds = []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            self._labels.append(_as_numpy(label).flatten())
            self._preds.append(_as_numpy(pred).flatten())
        l = onp.concatenate(self._labels)
        p = onp.concatenate(self._preds)
        self.sum_metric = float(onp.corrcoef(l, p)[0, 1])
        self.num_inst = 1


@register()
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for pred in preds:
            loss = _as_numpy(pred)
            self._update(loss.sum(), loss.size)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for label, pred in zip(labels, preds):
            v = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(v, tuple):
                s, n = v
                self._update(s, n)
            else:
                self._update(v)


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs) -> EvalMetric:
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        return CompositeEvalMetric(metric)
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    return _registry.get(metric)(*args, **kwargs)
