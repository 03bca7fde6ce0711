"""Mixed precision (counterpart of ``mxnet_tpu/amp/__init__.py``).

``amp.init()`` installs a *cast policy* for the calling thread (the
reference's is thread-local too, so a serving engine's scheduler thread
keeps its own).  Ops are classed by the reference's op names in
:mod:`.lists`: an op on the target list (``FullyConnected``,
``dot_product_attention``, ``flash_attention``, ``dot``, ...) sees its
float32 inputs cast to the target dtype (bf16 by default), so its
products run on the tensor cores; an op on the float32 list
(``softmax``, ``log_softmax``, ``LayerNorm``, ``logsumexp``, ...) sees
its bf16/fp16 inputs cast to float32; every other op takes what it is
given, and torch's type promotion widens mixed inputs (bf16 + float32
gives float32), as ``WIDEST_TYPE_CASTS`` asks.

The policy is consulted in two places, so both calling conventions
follow it: :func:`mxnet_tpu_torch.ndarray.ops.invoke` for the ``nd``
ops, and :func:`cast` on the tensor path that the reference also sends
through its dispatcher (``Dense`` and the tied LM head as
``FullyConnected``, ``LayerNorm``, the attention entry points).  The
casts sit inside torch's autograd graph, so the master weights and
their gradients stay float32.  With no policy nothing casts.

Also here: the dynamic loss-scaling schedule, :class:`LossScaler`,
which ``parallel.ShardedTrainer(loss_scaler=...)`` runs on the device,
and the guarded ``gluon.Trainer`` step behind :func:`init_trainer` /
:func:`scale_loss` / :func:`unscale`; :func:`convert_model` for
bf16/fp16 parameters.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import warnings
from typing import Optional

import torch

from ..base import MXNetError, torch_dtype
from .lists import FP16_FUNCS, FP32_FUNCS, WIDEST_TYPE_CASTS

__all__ = ["init", "reset", "current_policy", "policy_scope", "cast",
           "init_trainer", "scale_loss", "unscale", "convert_model",
           "convert_hybrid_block", "LossScaler", "amp_cast", "amp_multicast",
           "FP16_FUNCS", "FP32_FUNCS", "WIDEST_TYPE_CASTS"]


class _State(threading.local):
    policy = None          # each thread starts with amp off


_state = _State()
_WIDE = (torch.float32, torch.float64)
_NARROW = (torch.bfloat16, torch.float16)


class _Policy:
    """The op lists and the target dtype of one ``amp.init``."""

    def __init__(self, target_dtype):
        self.target_dtype = torch_dtype(target_dtype)
        self.target_ops = set(FP16_FUNCS)
        self.fp32_ops = set(FP32_FUNCS)

    def cast_args(self, opname, arrs):
        """``arrs`` (tensors, or None) as op ``opname`` takes them."""
        if opname in self.target_ops:
            dt = self.target_dtype
            return tuple(a.to(dt) if a is not None and a.dtype in _WIDE
                         else a for a in arrs)
        if opname in self.fp32_ops:
            return tuple(a.float() if a is not None and a.dtype in _NARROW
                         else a for a in arrs)
        return arrs


def current_policy() -> Optional[_Policy]:
    """This thread's policy, or None when amp is off."""
    return _state.policy


@contextlib.contextmanager
def policy_scope(policy):
    """Run with ``policy`` (a :func:`current_policy` value; None: amp
    off) as this thread's policy, then restore the previous one.  Remat
    uses it to recompute a layer under the policy of its forward."""
    prev, _state.policy = _state.policy, policy
    try:
        yield
    finally:
        _state.policy = prev


def cast(opname, *tensors):
    """``tensors`` cast as this thread's policy casts the inputs of op
    ``opname`` (unchanged when amp is off); None entries pass."""
    pol = _state.policy
    return tensors if pol is None else pol.cast_args(opname, tensors)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn the cast policy on for this thread (MXNet's ``amp.init``):
    ``'float16'``/``'fp16'`` targets fp16, anything else bf16;
    ``target_precision_ops`` and ``fp32_ops`` extend the lists."""
    if str(target_dtype) in ("float16", "fp16"):
        target_dtype = "float16"
    else:
        target_dtype = "bfloat16"
    p = _Policy(target_dtype)
    if target_precision_ops:
        p.target_ops |= set(target_precision_ops)
    if fp32_ops:
        p.fp32_ops |= set(fp32_ops)
    _state.policy = p
    return p


def reset():
    """Turn the cast policy off for this thread."""
    _state.policy = None


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
    attach = getattr(trainer, "attach_loss_scaler", None)
    if attach is not None:                       # ShardedTrainer
        attach(scaler)
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


def unscale(trainer):
    """Divide the gradients by the loss scale now (to clip or inspect
    them before ``step``), and leave the trainer's rescale at its
    unscaled value so ``step`` does not divide again.  A
    ``ShardedTrainer`` unscales on the device: nothing to do."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        if getattr(trainer, "_loss_scaler", None) is None:
            _warn_no_scaler("unscale")
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            if p.grad_req != "null":
                p.grad()._t.mul_(inv)
    trainer._scale = getattr(trainer, "_amp_original_scale", 1.0)


_KEEP_FP32 = ("gamma", "beta", "running_mean", "running_var")


def convert_model(net, target_dtype="bfloat16"):
    """Cast a model's float32 parameters to ``target_dtype``, keeping the
    norm parameters (``gamma``, ``beta``, ``running_mean``,
    ``running_var``) in float32 (MXNet's ``amp.convert_model``)."""
    dt = torch_dtype(target_dtype)
    for name, p in net.collect_params().items():
        if name.endswith(_KEEP_FP32):
            continue
        if p.tensor.dtype == torch.float32:
            p.cast(dt)
    return net


def convert_hybrid_block(net, target_dtype="bfloat16", ctx=None):
    return convert_model(net, target_dtype)


def amp_cast(data, dtype="bfloat16"):
    """``data`` (an NDArray or a tensor) cast to ``dtype``."""
    if isinstance(data, torch.Tensor):
        return data.to(torch_dtype(dtype))
    return data.astype(dtype)


def amp_multicast(*data, num_outputs=None):
    """The inputs cast to their widest dtype."""
    ts = [d if isinstance(d, torch.Tensor) else d.tensor for d in data]
    dt = functools.reduce(torch.promote_types, [t.dtype for t in ts])
    return [d.to(dt) if isinstance(d, torch.Tensor) else d.astype(dt)
            for d in data]
