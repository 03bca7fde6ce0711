"""Seeded random numbers (counterpart of ``mxnet_tpu/random.py``).

MXNet's RNG is stateful per device (``mx.random.seed(n)``).  The port
keeps one explicit ``torch.Generator`` per device and never draws from
torch's global generator: every stochastic op (dropout) asks
:func:`generator` for its device's.  :func:`seed` reseeds them all, or
one.  The same seed gives other numbers than the JAX package's (torch's
Philox, not jax's threefry); the contract kept is that one seed repeats
one stream.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .context import Context

__all__ = ["seed", "generator", "replay"]

# MXNet's device type ids (``Context.devtype2id``): a device's generator
# is seeded with base + (type id << 8) + index, as the reference derives
# its per-context root keys
_DEVTYPE_ID = {"cpu": 1, "cuda": 2}

_LOCK = threading.Lock()
_GENS: Dict[torch.device, torch.Generator] = {}
_BASE = [int(np.random.randint(0, 2 ** 31 - 1))]


def _key(device) -> torch.device:
    dev = device.torch_device if isinstance(device, Context) else \
        torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _new(dev: torch.device, base: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(base + (_DEVTYPE_ID.get(dev.type, 0) << 8)
                  + (dev.index or 0))
    return g


def seed(seed_state: int, ctx=None):
    """``mx.random.seed``: reseed every device's generator, or only that
    of ``ctx`` (a device)."""
    with _LOCK:
        if ctx is None:
            _BASE[0] = int(seed_state)
            _GENS.clear()
        else:
            dev = _key(ctx)
            _GENS[dev] = _new(dev, int(seed_state))


def generator(device: Optional[torch.device] = None) -> torch.Generator:
    """The generator of ``device`` (default: the CPU), created from the
    current seed on first use."""
    dev = _key(device if device is not None else "cpu")
    with _LOCK:
        g = _GENS.get(dev)
        if g is None:
            g = _GENS[dev] = _new(dev, _BASE[0])
        return g


@contextlib.contextmanager
def replay(device, state: torch.Tensor):
    """Draw from ``device``'s generator as from ``state`` (an earlier
    ``generator(device).get_state()``), then give the generator back the
    state it had on entry.  Remat recomputes a layer inside it, so the
    recomputation draws the forward's dropout masks and the draws after
    it are the ones a run without remat makes."""
    g = generator(device)
    after = g.get_state()
    g.set_state(state)
    try:
        yield
    finally:
        g.set_state(after)
