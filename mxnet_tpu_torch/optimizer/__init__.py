"""Optimizers (counterpart of ``mxnet_tpu/optimizer/__init__.py``, parity:
python/mxnet/optimizer/*.py).

The MXNet API is kept: index-keyed states, lr/wd multipliers,
``rescale_grad``, ``clip_gradient``, per-index update counts, an
optional ``lr_scheduler`` and the name registry behind :func:`create`.
Where the reference returns new arrays (jax is functional), an update
here writes the weight and its state **in place**, under
``torch.no_grad``, so a step allocates no second copy of the model.
This slice ports SGD, NAG, Adam and AdamW and the index-keyed
:class:`Updater` that ``gluon.Trainer`` drives; the other optimizers are
still to come.
"""
from __future__ import annotations

import io
from typing import Any, Dict

import numpy as np
import torch

from .. import base as _base

_registry = _base.registry("optimizer")
register = _registry.register

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "create",
           "register", "Updater", "get_updater"]


class Optimizer:
    """Base optimizer.  ``update(index, weight, grad, state)`` applies one
    step to ``weight`` (a tensor, updated in place) from ``grad``."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0,
                 **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    # -- lr/wd ------------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise _base.MXNetError(
                "LRScheduler attached; set lr via the scheduler")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _mult(self, index, table, attr):
        # a parameter in param_dict carries its own multiplier (a plain
        # torch parameter has none: 1.0); else the index or name tables
        p = self.param_dict.get(index)
        if p is not None:
            return getattr(p, attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.learning_rate * self._mult(index, self.lr_mult,
                                               "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def traced(self, lr, t):
        """Context manager that fixes one training step: the learning
        rate reads ``lr`` and every index's update count reads ``t``, and
        count bookkeeping is suspended.  The reference uses it to run the
        optimizer inside its jitted step; ``ShardedTrainer`` uses it here
        so that every parameter of a step sees ``t = num_update``
        (``parallel/trainer.py:711-713``)."""
        return _TracedMode(self, lr, t)

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == torch.float16:
            master = weight.detach().float().clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- update -----------------------------------------------------------
    def _preprocess_grad(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight.dtype == torch.float16:
            master, sub_state = state
            self.update(index, master, grad.float(), sub_state)
            weight.copy_(master.to(torch.float16))
        else:
            self.update(index, weight, grad, state)


class _TracedCount(dict):
    """Stands in for ``Optimizer._index_update_count`` during one fixed
    step: every index reads ``t``, writes are discarded."""

    def __init__(self, t):
        super().__init__()
        self._t = t

    def __getitem__(self, k):
        return self._t

    def __setitem__(self, k, v):
        pass

    def __contains__(self, k):
        return True


class _TracedMode:
    """Implementation of :meth:`Optimizer.traced`."""

    def __init__(self, opt, lr, t):
        self._opt, self._lr, self._t = opt, lr, t
        self._saved = None

    def __enter__(self):
        opt = self._opt
        self._saved = (opt.lr, opt.lr_scheduler, opt._index_update_count)
        opt.lr, opt.lr_scheduler = self._lr, None
        opt._index_update_count = _TracedCount(self._t)
        opt.__dict__["_update_count"] = lambda index: None
        return opt

    def __exit__(self, *a):
        opt = self._opt
        opt.lr, opt.lr_scheduler, opt._index_update_count = self._saved
        opt.__dict__.pop("_update_count", None)
        return False


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


@register()
class SGD(Optimizer):
    """SGD with momentum (parity: sgd_update / sgd_mom_update)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess_grad(grad) + wd * weight
        if state is not None:
            state.copy_(self.momentum * state - lr * g)
            weight.copy_(weight + state)
        else:
            weight.copy_(weight - lr * g)


@register()
class NAG(SGD):
    """Nesterov accelerated SGD (parity: nag_mom_update)."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess_grad(grad) + wd * weight
        if state is not None:
            state.copy_(self.momentum * state - lr * g)
            weight.copy_(weight + self.momentum * state - lr * g)
        else:
            weight.copy_(weight - lr * g)


@register()
class Adam(Optimizer):
    """Adam with the reference's bias correction folded into the step
    size, ``lr * sqrt(1 - beta2**t) / (1 - beta1**t)``, where ``t`` is
    the parameter's update count (``optimizer/__init__.py:247-258``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))  # mean, var

    def _moments(self, g, state):
        mean, var = state
        mean.copy_(self.beta1 * mean + (1 - self.beta1) * g)
        var.copy_(self.beta2 * var + (1 - self.beta2) * torch.square(g))
        return mean, var

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr *= (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        g = self._preprocess_grad(grad) + wd * weight
        m, v = self._moments(g, state)
        weight.copy_(weight - lr * m / (torch.sqrt(v) + self.epsilon))


@register()
class AdamW(Adam):
    """Adam with decoupled weight decay (parity: contrib/adamw.cc)."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        coef = (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        m, v = self._moments(self._preprocess_grad(grad), state)
        weight.copy_(weight - lr * (
            coef * m / (torch.sqrt(v) + self.epsilon) + wd * weight))


def create(name, **kwargs) -> Optimizer:
    """An optimizer by registered name (case-insensitive), or ``name``
    itself when it already is one."""
    if isinstance(name, Optimizer):
        return name
    return _registry.get(name)(**kwargs)


def _map_state(state, fn):
    """``state`` (None, a tensor or nested tuples/lists of them) with
    ``fn`` applied to every tensor; other leaves are kept."""
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(s, fn) for s in state)
    if isinstance(state, (torch.Tensor, np.ndarray)):
        return fn(state)
    return state


class Updater:
    """Keeps one optimizer state per index and applies the optimizer to
    ``(index, grad, weight)``, NDArrays or tensors; the weight is updated
    in place.  The row-sparse lazy update is not ported (the port has no
    sparse NDArray yet)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        w = getattr(weight, "_t", weight)
        g = getattr(grad, "_t", grad)
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, w.detach())
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            # loaded by set_states: onto the weight's device, once
            self.states[index] = _map_state(
                self.states[index], lambda s: torch.as_tensor(s).to(w.device))
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, w.detach(), g,
                                              self.states[index])

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states and update counts as the reference's bytes (a
        pickled numpy object array), so either package reads them."""
        buf = io.BytesIO()
        payload = {
            "__states__": {k: _map_state(v, lambda s: s.detach().cpu()
                                         .numpy()
                                         if isinstance(s, torch.Tensor)
                                         else s)
                           for k, v in self.states.items()},
            "__num_update__": self.optimizer.num_update,
            "__index_update_count__": dict(
                self.optimizer._index_update_count)}
        np.save(buf, np.asarray([payload], dtype=object), allow_pickle=True)
        return buf.getvalue()

    def set_states(self, states_bytes):
        loaded = np.load(io.BytesIO(states_bytes), allow_pickle=True)[0]
        states = loaded.get("__states__", loaded)
        self.states = {k: _map_state(v, lambda s: torch.from_numpy(
            np.array(s))) for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}
        if "__num_update__" in loaded:
            self.optimizer.num_update = int(loaded["__num_update__"])
            self.optimizer._index_update_count.update(
                loaded["__index_update_count__"])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
