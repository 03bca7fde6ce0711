"""Carry weights and trainer state across from the reference.

:func:`load_numpy_params` fills a port model from arrays keyed by the
reference's structural parameter names (``wte.weight``,
``h0.attn.q_proj.weight``, ``h0.ln1.gamma``, ...).  Dense weights are
(out, in) in both packages, so nothing is transposed.
:func:`load_numpy_state` fills a port ``ShardedTrainer`` from the
reference trainer's ``state_dict()`` (positional keys ``param:i``,
``aux:i``, ``state:i``, ``meta:*``): both packages collect parameters
and optimizer-state leaves in the same order.  Values may be numpy
arrays, tensors, or anything with ``asnumpy()`` (the reference's
NDArrays), so no import of the reference is needed."""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..gluon.parameter import (is_initialized, replace_parameter,
                               shape_known)

__all__ = ["load_numpy_params", "load_numpy_state"]


def _tensor(v) -> torch.Tensor:
    """A tensor of ``v``: a tensor, a numpy array, or an object with
    ``asnumpy()``."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    return torch.from_numpy(np.ascontiguousarray(v))


def load_numpy_state(trainer, state):
    """Load a flat trainer state dict (the reference's
    ``ShardedTrainer.state_dict()``, or the port's) into ``trainer``,
    building it first if needed; each value is cast to its target's
    dtype and device."""
    trainer.build()
    trainer.load_state_dict({k: _tensor(v) for k, v in state.items()})
    return trainer


def load_numpy_params(net, params, device=None, allow_missing=False,
                      ignore_extra=False):
    """Copy ``params`` ({structural name: np.ndarray or tensor}) into
    ``net``, cast to each parameter's dtype.  A parameter ``params``
    lacks raises unless ``allow_missing``; a name the model lacks
    raises unless ``ignore_extra``; a second name of a shared parameter
    is an alias and is not loaded.  Shapes must match, but for a
    deferred parameter's unknown (0) dimensions, which the value fills.
    An uninitialized parameter is materialized on ``device`` (default:
    the net's construction device, else the current CUDA device); an
    initialized one keeps its device."""
    slots = list(net._param_slots())
    names = {name for name, _m, _a in slots}
    # a block shared under two attributes (NMT's ``tgt_embed`` is
    # ``src_embed`` with ``shared_embed``) has its parameters under
    # both names in the reference's files; the second name is an alias
    aliases = {name for name, _p in
               net.named_parameters(remove_duplicate=False)} - names
    missing = sorted(names - set(params))
    extra = sorted(set(params) - names - aliases)
    if (missing and not allow_missing) or (extra and not ignore_extra):
        raise MXNetError(
            f"parameter names differ: missing {missing[:8]}, extra "
            f"{extra[:8]}")
    dev = None
    with torch.no_grad():
        for name, m, attr in slots:
            if name not in params:
                continue
            p = m._parameters[attr]
            t = _tensor(params[name])
            if is_initialized(p) or shape_known(p):
                fits = tuple(t.shape) == tuple(p.shape)
            else:
                fits = t.dim() == p.dim() and all(
                    d in (0, s) for d, s in zip(p.shape, t.shape))
            if not fits:
                raise MXNetError(f"Parameter '{name}': shape "
                                 f"{tuple(t.shape)} does not match the "
                                 f"model's {tuple(p.shape)}")
            if is_initialized(p):
                target = p.device
            else:
                if dev is None:
                    dev = net._target_device(device)
                target = dev
            replace_parameter(m, attr,
                              t.to(device=target, dtype=p.dtype).clone(),
                              p.requires_grad)
    if dev is not None:
        net._device = dev
    return net
