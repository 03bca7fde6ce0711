"""Subgraph partitioning API (counterpart of ``mxnet_tpu/subgraph.py``):
a registry of ``SubgraphProperty`` backends behind
``optimize_for(backend)``.

The surviving value of the API is semantic rewrites that no fusing
compiler does: folding BatchNorm statistics into convolution weights for
inference, swapping layers for INT8 equivalents.  They are expressed as
block-tree (and Symbol-DAG) rewriters.  Built-in backends:

- ``"FUSE_BN"``: fold inference-mode BatchNorm into the preceding
  Conv2D/Dense inside HybridSequential chains, as weight algebra.
- ``"INT8"``: swap Dense/Conv2D layers for int8 ones
  (``contrib.quantization.quantize_net``), calibrating on ``calib_data``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import base as _base

__all__ = ["SubgraphProperty", "register_backend", "list_backends",
           "optimize_for"]

_BACKENDS: Dict[str, "SubgraphProperty"] = {}


class SubgraphProperty:
    """A named graph-rewrite backend (parity: SubgraphProperty).

    Subclasses implement :meth:`apply_block` (Gluon block tree rewrite)
    and/or :meth:`apply_symbol` (Symbol DAG rewrite) and register with
    :func:`register_backend`.
    """

    name: str = ""

    def apply_block(self, net, **kwargs):
        return net

    def apply_symbol(self, sym, **kwargs):
        raise _base.MXNetError(
            f"backend {self.name or type(self).__name__!r} implements no "
            "Symbol rewrite — apply it to the Gluon block instead")


def register_backend(prop: SubgraphProperty, name: Optional[str] = None):
    """Parity: MXNET_REGISTER_SUBGRAPH_BACKEND/PROPERTY."""
    key = (name or prop.name).upper()
    if not key:
        raise _base.MXNetError("subgraph backend needs a name")
    _BACKENDS[key] = prop
    return prop


def list_backends():
    return sorted(_BACKENDS)


def get_backend(name: str) -> SubgraphProperty:
    key = str(name).upper()
    if key not in _BACKENDS:
        raise _base.MXNetError(
            f"unknown optimize_for backend {name!r}; registered: "
            f"{list_backends()}")
    return _BACKENDS[key]


def optimize_for(net_or_sym, backend, **kwargs):
    """Apply a registered backend to a Gluon block or Symbol."""
    prop = get_backend(backend)
    from .symbol import Symbol
    if isinstance(net_or_sym, Symbol):
        return prop.apply_symbol(net_or_sym, **kwargs)
    out = prop.apply_block(net_or_sym, **kwargs)
    _clear_cached_ops(out)
    return out


def _clear_cached_ops(block):
    """Invalidate every CachedOp in the tree: a rewrite that mutates
    params/children must not let an already-hybridized net replay its
    stale pre-rewrite graphs."""
    for m in block.modules():
        if hasattr(m, "_clear_cached_op"):
            m._clear_cached_op()


# ------------------------------------------------------------ FUSE_BN

def _fold_conv_bn(conv, bn):
    """Fold BN inference statistics into conv weight/bias in place (in
    float32, on the parameters' device)."""
    with torch.no_grad():
        w = conv.weight
        c = w.shape[0]
        ones = torch.ones(c, dtype=torch.float32, device=w.device)
        gamma = bn.gamma.float() if bn._scale else ones
        scale = gamma / torch.sqrt(bn.running_var.float() + bn._eps)
        b = conv.bias.float() if conv.bias is not None else \
            torch.zeros_like(ones)
        b2 = (b - bn.running_mean.float()) * scale + bn.beta.float()
        w.copy_(w.float() * scale.reshape((-1,) + (1,) * (w.dim() - 1)))
        if conv.bias is not None:
            conv.bias.copy_(b2)
            return conv
        # conv had no bias: grow one
        del conv.bias
        conv.register_parameter("bias", torch.nn.Parameter(
            b2.to(w.dtype), requires_grad=w.requires_grad))
    return conv


def _make_identity():
    """nn.Identity stand-in for a folded-away BatchNorm (keeps
    collect_params / children walks working)."""
    from .gluon.nn import Identity
    return Identity()


class FuseBNProperty(SubgraphProperty):
    """Conv2D/Dense + BatchNorm folding inside HybridSequential chains."""

    name = "FUSE_BN"

    def apply_block(self, net, **kwargs):
        from .gluon.nn import (BatchNorm, Conv2D, Dense,
                               HybridSequential)
        from .gluon.parameter import is_initialized

        def walk(block):
            if isinstance(block, HybridSequential):
                kids = list(block._modules.items())
                for (n1, c1), (n2, c2) in zip(kids, kids[1:]):
                    if isinstance(c1, (Conv2D, Dense)) \
                            and isinstance(c2, BatchNorm) \
                            and getattr(c1, "_activation", None) is None \
                            and is_initialized(c1.weight) \
                            and is_initialized(c2.running_mean):
                        # (a fused activation on c1 would make this
                        # BN(act(conv(x))) — not foldable weight algebra)
                        _fold_conv_bn(c1, c2)
                        block._modules[n2] = _make_identity()
            for child in list(block.children()):
                walk(child)
            return block

        return walk(net)


register_backend(FuseBNProperty())


# --------------------------------------------------------------- INT8

class Int8Property(SubgraphProperty):
    """Quantization as a subgraph backend: ``contrib.quantization.
    quantize_net`` run through ``optimize_for``, as the reference's."""

    name = "INT8"

    def apply_block(self, net, calib_data=None, calib_mode="naive",
                    exclude_layers=None, **kwargs):
        from .contrib.quantization import quantize_net
        return quantize_net(net, calib_data=calib_data,
                            calib_mode=calib_mode,
                            exclude_layers=exclude_layers)


register_backend(Int8Property())
