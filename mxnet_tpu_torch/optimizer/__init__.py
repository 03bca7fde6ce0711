"""Optimizers (counterpart of ``mxnet_tpu/optimizer/__init__.py``, parity:
python/mxnet/optimizer/*.py).

The MXNet API is kept: index-keyed states, lr/wd multipliers,
``rescale_grad``, ``clip_gradient``, per-index update counts, an
optional ``lr_scheduler`` and the name registry behind :func:`create`.
Every optimizer the reference registers is here (SGD, NAG, Adam, AdamW,
RMSProp, Adagrad, AdaDelta, Adamax, Ftrl, LAMB, LARS, Signum, DCASGD),
with the reference's state layout (tuple order and dtypes), so optimizer
state files and trainer state dicts cross packages.  Where the reference
returns new arrays (jax is functional), an update here writes the weight
and its state **in place**, under ``torch.no_grad``, so a step allocates
no second copy of the model.

``update(index, weight, grad, state)`` is the definition of each rule.
:meth:`Optimizer.update_multi` applies one step to lists of parameters
at once, as ``torch._foreach_*`` ops over the lists (LAMB and LARS take
their per-tensor norms with ``torch._foreach_norm``): the port's form of
the reference's single compiled update (``parallel/trainer.py:636-650``),
which ``gluon.Trainer`` and ``ShardedTrainer`` always use.  A rule with
no list-wise form (Ftrl) runs its ``update`` per parameter there.

Inside :meth:`Optimizer.traced` the learning rate and the update count
may be 0-d tensors on the device (``ShardedTrainer`` passes them so, the
reference's traced ``lr`` and ``t``): every rule then computes its
step-dependent factors (Adam's ``beta ** t``, LAMB's bias correction,
Signum's decay) on the device, once per step, so a CUDA graph of the
step reads the values the host writes before each replay.
"""
from __future__ import annotations

import io
from typing import Any, Dict

import numpy as np
import torch

from .. import base as _base

_registry = _base.registry("optimizer")
register = _registry.register

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "RMSProp", "Adagrad",
           "AdaDelta", "Adamax", "Ftrl", "LAMB", "LARS", "Signum", "DCASGD",
           "create", "register", "Updater", "get_updater"]


def _owner(cls, name):
    return next(c for c in cls.__mro__ if name in c.__dict__)


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

    @staticmethod
    def create_optimizer(name, **kwargs):
        """An optimizer by registered name (MXNet's
        ``Optimizer.create_optimizer``)."""
        return _registry.get(name)(**kwargs)

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
        mult = self._mult(index, self.lr_mult, "lr_mult")
        # a traced step's lr tensor stays one object where mult is 1
        return self.learning_rate if mult == 1.0 else \
            self.learning_rate * mult

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
        (``parallel/trainer.py:711-713``).  ``lr`` and ``t`` may be
        numbers or 0-d tensors on the parameters' device (float32 and
        int32, as the reference traces them)."""
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

    # -- list-wise update -------------------------------------------------
    # A subclass gives its rule a list-wise form by defining
    # ``_multi(weights, grads, states, lrs, wds, ts)`` beside ``update``:
    # ``grads`` are already rescaled and clipped (fresh tensors it may
    # overwrite); ``lrs``, ``wds`` and ``ts`` are each index's learning
    # rate, weight decay and update count.
    _multi = None

    @classmethod
    def _has_multi(cls) -> bool:
        """Whether the class's ``_multi`` is the list-wise form of its own
        ``update`` (a subclass that redefines ``update`` alone loops)."""
        owner = _owner(cls, "_multi")
        return owner is not Optimizer and owner is _owner(cls, "update")

    @torch.no_grad()
    def update_multi(self, indices, weights, grads, states):
        """One step over lists of parameters, weights and states updated
        in place; the same step as ``update_multi_precision`` applied to
        each index in turn (counts, learning rates and schedules
        included)."""
        if not type(self)._has_multi() or (self.multi_precision and any(
                w.dtype == torch.float16 for w in weights)):
            for i, w, g, s in zip(indices, weights, grads, states):
                self.update_multi_precision(i, w, g, s)
            return
        if not indices:
            return
        lrs, wds, ts = [], [], []
        for i in indices:
            self._update_count(i)
            lrs.append(self._get_lr(i))
            wds.append(self._get_wd(i))
            ts.append(self._index_update_count[i])
        gs = torch._foreach_mul(list(grads), self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(gs, -self.clip_gradient)
            torch._foreach_clamp_max_(gs, self.clip_gradient)
        self._multi(list(weights), gs, list(states), lrs, wds, ts)


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


# -- list-wise helpers: each rounds its products as the per-parameter
# rule's expressions do, one op at a time --------------------------------

def _each(fn, *cols):
    """``fn`` over the columns' entries, computed once per distinct
    entry: a traced step's 0-d tensors are one object for every index,
    so a step-dependent factor costs a few launches a step, not a few a
    parameter."""
    memo, out = {}, []
    for args in zip(*cols):
        key = tuple(id(a) if isinstance(a, torch.Tensor) else a
                    for a in args)
        if key not in memo:
            memo[key] = fn(*args)
        out.append(memo[key])
    return out


def _shared(scalars):
    """The one value every entry of ``scalars`` is, or None."""
    first = scalars[0] if scalars else None
    return first if all(s is first for s in scalars) else None


def _mul(xs, scalars):
    """``xs[i] * scalars[i]`` (numbers or 0-d tensors): one list-wise
    product by a shared value where they are one."""
    one = _shared(scalars)
    return torch._foreach_mul(xs, one if one is not None else scalars)


def _mul_(xs, scalars):
    """:func:`_mul` in place."""
    one = _shared(scalars)
    torch._foreach_mul_(xs, one if one is not None else scalars)


def _div(xs, scalars):
    """``xs[i] / scalars[i]``, as :func:`_mul`."""
    one = _shared(scalars)
    return torch._foreach_div(xs, one if one is not None else scalars)


def _plus_wd_(gs, weights, wds):
    """``g + wd * weight`` for every pair, into ``gs``."""
    torch._foreach_add_(gs, _mul(weights, wds))


def _ema_(xs, beta, ys):
    """``x = beta * x + (1 - beta) * y`` for every pair, into ``xs``."""
    torch._foreach_mul_(xs, beta)
    torch._foreach_add_(xs, torch._foreach_mul(ys, 1 - beta))


def _square(xs):
    return torch._foreach_mul(xs, xs)


def _columns(states, n):
    """The ``n`` leaves of tuple states as ``n`` lists."""
    return [list(c) for c in zip(*states)] if states else [[]] * n


def _norm(x):
    return torch.linalg.vector_norm(x)


def _norms(xs):
    """The L2 norms of ``xs`` as one vector."""
    return torch.stack(torch._foreach_norm(xs))


def _scale_each(xs, vector, scalars):
    """``xs[i] * (vector[i] * scalars[i])``: per-tensor factors from a
    device vector, without a copy from the host."""
    factors = _mul(list(vector.unbind(0)), scalars)
    return torch._foreach_mul(xs, factors)


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

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        step = _mul(gs, lrs)
        if self.momentum == 0.0:
            torch._foreach_sub_(weights, step)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, step)
        torch._foreach_add_(weights, states)


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

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        step = _mul(gs, lrs)
        if self.momentum != 0.0:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_sub_(states, step)
            torch._foreach_add_(weights,
                                torch._foreach_mul(states, self.momentum))
        torch._foreach_sub_(weights, step)


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

    def _moments_multi(self, gs, states):
        means, variances = _columns(states, 2)
        _ema_(means, self.beta1, gs)
        _ema_(variances, self.beta2, _square(gs))
        return means, variances

    def _coef(self, t):
        return (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr *= self._coef(t)
        g = self._preprocess_grad(grad) + wd * weight
        m, v = self._moments(g, state)
        weight.copy_(weight - lr * m / (torch.sqrt(v) + self.epsilon))

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        means, variances = self._moments_multi(gs, states)
        denom = torch._foreach_sqrt(variances)
        torch._foreach_add_(denom, self.epsilon)
        step = _mul(means, _each(lambda lr, t: lr * self._coef(t), lrs,
                                 ts))
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(weights, step)


@register()
class AdamW(Adam):
    """Adam with decoupled weight decay (parity: contrib/adamw.cc)."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        coef = self._coef(t)
        m, v = self._moments(self._preprocess_grad(grad), state)
        weight.copy_(weight - lr * (
            coef * m / (torch.sqrt(v) + self.epsilon) + wd * weight))

    def _multi(self, weights, gs, states, lrs, wds, ts):
        means, variances = self._moments_multi(gs, states)
        denom = torch._foreach_sqrt(variances)
        torch._foreach_add_(denom, self.epsilon)
        step = _mul(means, _each(self._coef, ts))
        torch._foreach_div_(step, denom)
        torch._foreach_add_(step, torch._foreach_mul(weights, wds))
        _mul_(step, lrs)
        torch._foreach_sub_(weights, step)


@register()
class RMSProp(Optimizer):
    """RMSProp, plain (state ``(n,)``) or ``centered`` (state ``(n, g,
    delta)``, with momentum), as ``optimizer/__init__.py:281``."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum = rho, momentum
        self.epsilon, self.centered = epsilon, centered

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))                  # n, g, delta
        return (_zeros_like(weight),)                     # n

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess_grad(grad) + wd * weight
        n = state[0]
        n.copy_(self.rho * n + (1 - self.rho) * torch.square(g))
        if self.centered:
            _, gbar, delta = state
            gbar.copy_(self.rho * gbar + (1 - self.rho) * g)
            delta.copy_(self.momentum * delta - lr * g / torch.sqrt(
                n - torch.square(gbar) + self.epsilon))
            weight.copy_(weight + delta)
        else:
            weight.copy_(weight - lr * g / torch.sqrt(n + self.epsilon))

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        cols = _columns(states, 3 if self.centered else 1)
        ns = cols[0]
        _ema_(ns, self.rho, _square(gs))
        step = _mul(gs, lrs)
        if self.centered:
            gbars, deltas = cols[1], cols[2]
            _ema_(gbars, self.rho, gs)
            denom = torch._foreach_sub(ns, _square(gbars))
        else:
            denom = ns
        denom = torch._foreach_add(denom, self.epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(step, denom)
        if self.centered:
            torch._foreach_mul_(deltas, self.momentum)
            torch._foreach_sub_(deltas, step)
            torch._foreach_add_(weights, deltas)
        else:
            torch._foreach_sub_(weights, step)


@register()
class Adagrad(Optimizer):
    """Adagrad; the state is the running sum of squared gradients."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess_grad(grad) + wd * weight
        state.copy_(state + torch.square(g))
        weight.copy_(weight - lr * g / torch.sqrt(
            state + self.float_stable_eps))

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        torch._foreach_add_(states, _square(gs))
        denom = torch._foreach_add(states, self.float_stable_eps)
        torch._foreach_sqrt_(denom)
        step = _mul(gs, lrs)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(weights, step)


@register()
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate); state ``(acc_g, acc_delta)``."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        g = self._preprocess_grad(grad) + wd * weight
        acc_g.copy_(self.rho * acc_g + (1 - self.rho) * torch.square(g))
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(acc_g + self.epsilon) * g
        acc_delta.copy_(self.rho * acc_delta
                        + (1 - self.rho) * torch.square(delta))
        weight.copy_(weight - delta)

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        acc_g, acc_delta = _columns(states, 2)
        _ema_(acc_g, self.rho, _square(gs))
        delta = torch._foreach_add(acc_delta, self.epsilon)
        torch._foreach_sqrt_(delta)
        denom = torch._foreach_add(acc_g, self.epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(delta, denom)
        torch._foreach_mul_(delta, gs)
        _ema_(acc_delta, self.rho, _square(delta))
        torch._foreach_sub_(weights, delta)


@register()
class Adamax(Optimizer):
    """Adamax: Adam with the infinity norm; state ``(mean, u)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        mean, u = state
        g = self._preprocess_grad(grad) + wd * weight
        mean.copy_(self.beta1 * mean + (1 - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
        weight.copy_(weight - lr * mean / (u + 1e-8))

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        means, us = _columns(states, 2)
        _ema_(means, self.beta1, gs)
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        step = _mul(means, _each(lambda lr, t: lr / (1.0 - self.beta1 ** t),
                                 lrs, ts))
        torch._foreach_div_(step, torch._foreach_add(us, 1e-8))
        torch._foreach_sub_(weights, step)


@register()
class Ftrl(Optimizer):
    """FTRL-Proximal; state ``(z, n)``.  Its thresholded weight has no
    list-wise form: ``update_multi`` runs ``update`` per parameter."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))  # z, n

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        zs, ns = state
        g = self._preprocess_grad(grad)
        n_new = ns + torch.square(g)
        sigma = (torch.sqrt(n_new) - torch.sqrt(ns)) / lr
        zs.copy_(zs + g - sigma * weight)
        ns.copy_(n_new)
        weight.copy_(torch.where(
            torch.abs(zs) <= self.lamda1, torch.zeros_like(weight),
            -(zs - torch.sign(zs) * self.lamda1)
            / ((self.beta + torch.sqrt(n_new)) / lr + wd)))


@register()
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch training (parity:
    contrib/multi_lamb.cc): Adam's moments, then each tensor's step
    scaled by ``||w|| / ||r||`` (1 where either is 0), clipped to
    ``lower_bound``/``upper_bound``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _trust(self, w_norm, r_norm):
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        if self.lower_bound is not None:
            ratio = torch.clamp(ratio, min=self.lower_bound)
        if self.upper_bound is not None:
            ratio = torch.clamp(ratio, max=self.upper_bound)
        return ratio

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        mean, var = state
        g = self._preprocess_grad(grad)
        mean.copy_(self.beta1 * mean + (1 - self.beta1) * g)
        var.copy_(self.beta2 * var + (1 - self.beta2) * torch.square(g))
        if self.bias_correction:
            m_hat = mean / (1 - self.beta1 ** t)
            v_hat = var / (1 - self.beta2 ** t)
        else:
            m_hat, v_hat = mean, var
        r = m_hat / (torch.sqrt(v_hat) + self.epsilon) + wd * weight
        ratio = self._trust(_norm(weight), _norm(r))
        weight.copy_(weight - lr * ratio * r)

    def _multi(self, weights, gs, states, lrs, wds, ts):
        means, variances = _columns(states, 2)
        _ema_(means, self.beta1, gs)
        _ema_(variances, self.beta2, _square(gs))
        if self.bias_correction:
            m_hat = _div(means, _each(lambda t: 1 - self.beta1 ** t, ts))
            v_hat = _div(variances, _each(lambda t: 1 - self.beta2 ** t, ts))
        else:
            m_hat, v_hat = means, variances
        denom = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(denom, self.epsilon)
        r = torch._foreach_div(m_hat, denom)
        del m_hat, v_hat, denom
        _plus_wd_(r, weights, wds)
        ratio = self._trust(_norms(weights), _norms(r))
        torch._foreach_sub_(weights, _scale_each(r, ratio, lrs))


@register()
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: each tensor's gradient scaled by
    ``eta ||w|| / (||g|| + wd ||w|| + eps)`` (1 where a norm is 0), then
    SGD with momentum."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _trust(self, w_norm, g_norm, scaled):
        return torch.where((w_norm > 0) & (g_norm > 0), scaled,
                           torch.ones_like(w_norm))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess_grad(grad)
        w_norm, g_norm = _norm(weight), _norm(g)
        trust = self._trust(w_norm, g_norm, self.eta * w_norm / (
            g_norm + wd * w_norm + self.epsilon))
        g = trust * (g + wd * weight)
        if state is not None:
            state.copy_(self.momentum * state - lr * g)
            weight.copy_(weight + state)
        else:
            weight.copy_(weight - lr * g)

    def _multi(self, weights, gs, states, lrs, wds, ts):
        w_norms, g_norms = torch._foreach_norm(weights), \
            torch._foreach_norm(gs)
        denom = torch._foreach_add(g_norms,
                                   torch._foreach_mul(w_norms, wds))
        torch._foreach_add_(denom, self.epsilon)
        scaled = torch._foreach_mul(w_norms, self.eta)
        torch._foreach_div_(scaled, denom)
        trust = self._trust(torch.stack(w_norms), torch.stack(g_norms),
                            torch.stack(scaled))
        _plus_wd_(gs, weights, wds)
        gs = torch._foreach_mul(gs, list(trust.unbind(0)))
        step = _mul(gs, lrs)
        if self.momentum == 0.0:
            torch._foreach_sub_(weights, step)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, step)
        torch._foreach_add_(weights, states)


@register()
class Signum(Optimizer):
    """signSGD with momentum: the step is ``lr * sign(momentum)``, with
    decoupled decay ``wd_lh``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess_grad(grad) + wd * weight
        if state is not None:
            state.copy_(self.momentum * state - (1 - self.momentum) * g)
            step = torch.sign(state)
        else:
            step = -torch.sign(g)
        weight.copy_((1 - lr * self.wd_lh) * weight + lr * step)

    def _multi(self, weights, gs, states, lrs, wds, ts):
        _plus_wd_(gs, weights, wds)
        if self.momentum != 0.0:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_sub_(states,
                                torch._foreach_mul(gs, 1 - self.momentum))
            step = torch._foreach_sign(states)
        else:
            step = torch._foreach_sign(gs)
            torch._foreach_neg_(step)
        _mul_(weights, _each(lambda lr: 1 - lr * self.wd_lh, lrs))
        torch._foreach_add_(weights, _mul(step, lrs))


@register()
class DCASGD(SGD):
    """The delay-compensated variant degenerates to SGD in synchronous
    training, as in the reference."""


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


def _put_rows(full, sub, rows, shape):
    """Write the gathered rows ``sub`` of each state shaped ``shape``
    back into ``full``, in place."""
    if isinstance(full, (tuple, list)):
        for f, s in zip(full, sub):
            _put_rows(f, s, rows, shape)
    elif isinstance(full, torch.Tensor) and tuple(full.shape) == shape:
        full.index_copy_(0, rows, sub)


class Updater:
    """Keeps one optimizer state per index and applies the optimizer to
    ``(index, grad, weight)``, NDArrays or tensors; the weight is updated
    in place.  ``index``, ``grad`` and ``weight`` may be lists, as in
    MXNet's aggregated update: the optimizer then takes one list-wise
    step (:meth:`Optimizer.update_multi`).  A ``RowSparseNDArray``
    gradient takes the lazy row update instead (unless the optimizer's
    ``lazy_update`` is False, which reads its dense form): only the rows
    it holds touch the weight and the state, so the other rows skip
    even the decay of their state (the reference's ``_lazy_row_update``,
    MXNet's ``lazy_update=True`` on row-sparse gradients)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def _state(self, index, w):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, w)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            # loaded by set_states: onto the weight's device, once
            self.states[index] = _map_state(
                self.states[index], lambda s: torch.as_tensor(s).to(w.device))
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        from ..ndarray.sparse import RowSparseNDArray
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        lazy = getattr(self.optimizer, "lazy_update", True)
        dense = []
        for i, g, w in zip(index, grad, weight):
            w = getattr(w, "_t", w).detach()
            if isinstance(g, RowSparseNDArray) and lazy:
                self._lazy_row_update(i, g, w)
            else:
                dense.append((i, w, getattr(g, "_t", g)))
        if dense:
            ids, ws, gs = (list(x) for x in zip(*dense))
            states = [self._state(i, w) for i, w in zip(ids, ws)]
            self.optimizer.update_multi(ids, ws, gs, states)

    @torch.no_grad()
    def _lazy_row_update(self, index, grad, w):
        """The step on the rows of ``grad`` alone: they are gathered from
        the weight and from every state shaped like it
        (``index_select``), updated by the optimizer's own rule, and
        written back in place (``index_copy_``)."""
        rows = grad._sp_indices
        state = self._state(index, w)

        def take(s):
            return s.index_select(0, rows) if tuple(s.shape) == \
                tuple(w.shape) else s

        sub_w = w.index_select(0, rows)
        sub_state = _map_state(state, take)
        self.optimizer.update_multi_precision(index, sub_w, grad._sp_data,
                                              sub_state)
        w.index_copy_(0, rows, sub_w)
        _put_rows(state, sub_state, rows, tuple(w.shape))

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
