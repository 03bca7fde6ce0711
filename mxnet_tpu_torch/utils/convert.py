"""Carry weights across: fill a port model from arrays keyed by the
reference's structural parameter names (``wte.weight``,
``h0.attn.q_proj.weight``, ``h0.ln1.gamma``, ...).  Dense weights are
(out, in) in both packages, so nothing is transposed."""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..gluon.parameter import is_initialized

__all__ = ["load_numpy_params"]


def load_numpy_params(net, params, device=None):
    """Copy ``params`` ({structural name: np.ndarray or tensor}) into
    ``net``, cast to each parameter's dtype; the key sets and every
    shape must match exactly.  An uninitialized parameter is
    materialized on ``device`` (default: the net's construction device,
    else the current CUDA device); an initialized one keeps its
    device."""
    slots = list(net._param_slots())
    names = {name for name, _m, _a in slots}
    if set(params) != names:
        raise MXNetError(
            f"parameter names differ: missing "
            f"{sorted(names - set(params))[:8]}, extra "
            f"{sorted(set(params) - names)[:8]}")
    dev = None
    with torch.no_grad():
        for name, m, attr in slots:
            p = m._parameters[attr]
            v = params[name]
            t = v.detach() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(v))
            if tuple(t.shape) != tuple(p.shape):
                raise MXNetError(f"Parameter '{name}': shape "
                                 f"{tuple(t.shape)} does not match the "
                                 f"model's {tuple(p.shape)}")
            if is_initialized(p):
                target = p.device
            else:
                if dev is None:
                    dev = net._target_device(device)
                target = dev
            net._replace(m, attr, t.to(device=target, dtype=p.dtype).clone(),
                         p.requires_grad)
    if dev is not None:
        net._device = dev
    return net
