"""1.x ``mx.model`` surface (counterpart of ``mxnet_tpu/model.py``).

The checkpoint helpers: ``{prefix}-symbol.json`` (the symbol's JSON) and
``{prefix}-{epoch:04d}.params`` (an ``MXTPU1`` container with
``arg:``/``aux:`` key prefixes), the files Module.save_checkpoint
writes.  Both files cross between the two packages either way.
"""
from __future__ import annotations

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Parity: mx.model.save_checkpoint."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    payload.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd.save(f"{prefix}-{epoch:04d}.params", payload)


def load_params(prefix, epoch):
    """(arg_params, aux_params) from ``{prefix}-{epoch:04d}.params``."""
    saved = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params = {k[4:]: v for k, v in saved.items()
                  if k.startswith("arg:")}
    aux_params = {k[4:]: v for k, v in saved.items()
                  if k.startswith("aux:")}
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Parity: mx.model.load_checkpoint → (symbol, arg_params,
    aux_params)."""
    from . import symbol as sym_mod
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


# the namedtuple Module.fit actually passes to callbacks — one type,
# aliased here as upstream does (mx.model.BatchEndParam)
from .callback import BatchEndParam  # noqa: E402,F401
