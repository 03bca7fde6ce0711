"""Seeded random numbers (counterpart of ``mxnet_tpu/random.py``).

MXNet's RNG is stateful per device (``mx.random.seed(n)``).  The port
keeps one explicit ``torch.Generator`` per device and never draws from
torch's global generator: every stochastic op (dropout) asks
:func:`generator` for its device's.  :func:`seed` reseeds them all, or
one.  The same seed gives other numbers than the JAX package's (torch's
Philox, not jax's threefry); the contract kept is that one seed repeats
one stream.

Inside a CUDA graph (a hybridized block's or ``ShardedTrainer``'s
program, ``utils/graphs.py``) a draw cannot read the generator's state
on the host.  The device generator is registered with every training
graph, so each replay draws fresh numbers from it; :func:`seed`
reseeds the generator objects in place, so graphs captured before it
see the new seed.  A remat layer inside a program draws its masks from
a pair of twin states instead (:class:`GraphDraws`, the counterpart of
the reference's traced key): its forward from one, its recomputation
from the other, both seeded alike when the program is built, and the
program sets the second to the first's offset before each replay of the
recomputation, so the recomputation draws the forward's masks.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .analysis.lockwitness import named_lock as _named_lock
from .context import Context

__all__ = ["seed", "generator", "replay", "GraphDraws", "graph_draws",
           "drawing_from", "RandomState", "get_state", "host_rng"]

# MXNet's device type ids (``Context.devtype2id``): a device's generator
# is seeded with base + (type id << 8) + index, as the reference derives
# its per-context root keys
_DEVTYPE_ID = {"cpu": 1, "cuda": 2}

_LOCK = _named_lock("random.generator", "seeded generator state")
_GENS: Dict[torch.device, torch.Generator] = {}
_BASE = [int(np.random.randint(0, 2 ** 31 - 1))]
# twin states made since the last seed(), by device
_TWINS: Dict[torch.device, int] = {}
_BUILDING = threading.local()      # the program being built on a thread


def _key(device) -> torch.device:
    dev = device.torch_device if isinstance(device, Context) else \
        torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_seed(dev: torch.device, base: int) -> int:
    return base + (_DEVTYPE_ID.get(dev.type, 0) << 8) + (dev.index or 0)


def _new(dev: torch.device, base: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(_device_seed(dev, base))
    return g


class RandomState:
    """The process's random state: each device's generator (created on
    first use from the seed) and the host-side numpy ``RandomState`` the
    data samplers shuffle with.  ``mx.random.seed`` reseeds both, so the
    same seed gives the reference's shuffle orders bit for bit (the
    device draws keep the contracts, not the bits)."""

    def __init__(self, seed_: int = 0):
        self._host_rng = np.random.RandomState(int(seed_) & 0x7FFFFFFF)

    def seed(self, seed_: int, ctx=None):
        _seed_devices(seed_, ctx)
        if ctx is None:
            self._host_rng = np.random.RandomState(int(seed_) & 0x7FFFFFFF)

    def generator(self, device=None) -> torch.Generator:
        return generator(device)


def seed(seed_state: int, ctx=None):
    """``mx.random.seed``: reseed every device's generator and the host
    shuffle state, or only the generator of ``ctx`` (a device)."""
    _STATE.seed(seed_state, ctx=ctx)


def get_state() -> RandomState:
    return _STATE


def host_rng() -> np.random.RandomState:
    """The process-global host-side numpy ``RandomState`` (follows
    ``mx.random.seed``); the data samplers shuffle with it."""
    return _STATE._host_rng


def _seed_devices(seed_state: int, ctx=None):
    with _LOCK:
        if ctx is None:
            _BASE[0] = int(seed_state)
            # in place: a graph holds its generators' states
            for dev, g in _GENS.items():
                g.manual_seed(_device_seed(dev, _BASE[0]))
            _TWINS.clear()
        else:
            dev = _key(ctx)
            if dev in _GENS:
                _GENS[dev].manual_seed(_device_seed(dev, int(seed_state)))
            else:
                _GENS[dev] = _new(dev, int(seed_state))
            _TWINS.pop(dev, None)


_STATE = RandomState(_BASE[0])


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


class GraphDraws:
    """The generator states one graphed program draws from on
    ``device``: the device generator and the twin states of its remat
    layers, in the order the layers ask for them.  The program's
    warm-up run makes the twins; its captures ask again in the same
    order and get the same ones (a capture asking for a new one
    raises: a state must be registered before its capture begins)."""

    def __init__(self, device):
        self.device = _key(device)
        self.twins = []          # (forward, recomputation) generators
        self._next = 0
        self.frozen = False

    def twin(self):
        """The next remat layer's (forward, recomputation) states."""
        if self._next == len(self.twins):
            if self.frozen:
                from .base import MXNetError
                raise MXNetError("a remat layer asked for a generator "
                                 "state its program's warm-up did not make")
            with _LOCK:
                n = _TWINS.get(self.device, 0)
                _TWINS[self.device] = n + 1
            s = (generator(self.device).initial_seed() * 1000003 + n + 1) \
                % (2 ** 63)
            self.twins.append(tuple(torch.Generator(device=self.device)
                                    .manual_seed(s) for _ in range(2)))
        pair = self.twins[self._next]
        self._next += 1
        return pair

    def generators(self):
        """The states to register with the program's graphs: the device
        generator and both states of every twin (a graph that draws
        nothing from a state leaves it as it was)."""
        return [generator(self.device)] + \
            [g for pair in self.twins for g in pair]

    def offsets(self):
        """The forward states' offsets (read on the host)."""
        return [f.get_offset() for f, _r in self.twins]

    def align(self, offsets=None):
        """Set each recomputation state to its forward state's offset
        (``offsets``, as :meth:`offsets` read them; default now)."""
        offs = self.offsets() if offsets is None else offsets
        for (_f, r), off in zip(self.twins, offs):
            r.set_offset(off)

    @contextlib.contextmanager
    def building(self, frozen=False):
        """Make this the program being built on this thread (for one run
        of its function, from its first twin)."""
        prev = getattr(_BUILDING, "draws", None)
        self._next, self.frozen = 0, frozen
        _BUILDING.draws = self
        try:
            yield self
        finally:
            _BUILDING.draws = prev


def graph_draws() -> Optional[GraphDraws]:
    """The :class:`GraphDraws` of the program being built on this
    thread, or None."""
    return getattr(_BUILDING, "draws", None)


@contextlib.contextmanager
def drawing_from(device, state: torch.Generator):
    """Make ``device``'s generator draw from ``state`` (a twin) and then
    from its own state again, in a way a capture may record
    (``graphsafe_set_state``)."""
    g = generator(device)
    own = g.graphsafe_get_state()
    g.graphsafe_set_state(state)
    try:
        yield
    finally:
        g.graphsafe_set_state(own)
