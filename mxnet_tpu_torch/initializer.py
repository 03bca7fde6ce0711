"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

An initializer fills one tensor in place from an explicit
``torch.Generator``.  As in the reference, parameters are filled by
name: ``gamma`` with ones, ``beta``/``bias`` with zeros, anything else
by the initializer passed to ``initialize`` (default ``Uniform(0.07)``).
The same seed gives different numbers here than in the JAX package:
torch's generators are not jax's threefry, so parity runs copy
parameters across instead of re-drawing them.
"""
from __future__ import annotations

import torch

__all__ = ["Initializer", "Uniform"]


class Initializer:
    """Base initializer; subclasses implement :meth:`_init_weight`."""

    def init_tensor(self, name: str, t: torch.Tensor,
                    generator: torch.Generator):
        """Fill ``t`` in place by the reference's name rules."""
        name_l = name.lower()
        if name_l.endswith("gamma"):
            t.fill_(1.0)
        elif name_l.endswith("beta") or name_l.endswith("bias"):
            t.zero_()
        else:
            self._init_weight(t, generator)

    def _init_weight(self, t: torch.Tensor, generator: torch.Generator):
        raise NotImplementedError


class Uniform(Initializer):
    """U(-scale, scale), drawn in float32 and cast to the parameter's
    dtype (the reference draws in f32 too)."""

    def __init__(self, scale: float = 0.07):
        self.scale = float(scale)

    def _init_weight(self, t, generator):
        draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        draw.uniform_(-self.scale, self.scale, generator=generator)
        t.copy_(draw)

    def __repr__(self):
        return f"Uniform(scale={self.scale})"
