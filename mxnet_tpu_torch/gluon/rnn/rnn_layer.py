"""Fused multi-layer RNN / LSTM / GRU layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``).

Parameters are the reference's: ``{l|r}{layer}_{i2h|h2h}_{weight|bias}``
on the layer itself (``l`` the forward direction, ``r`` the backward),
weights (G·H, in) with G the gate count.  ``input_size=0`` defers layer
0's i2h weights to the first call.  The compute is
:func:`._rnn_impl.rnn_layer_forward`: cuDNN through torch's recurrent op
on the card, the reference's step-by-step decomposition on the CPU."""
from __future__ import annotations

import torch

from ... import amp as _amp
from ... import base as _base
from ...ndarray import ndarray as _ndmod
from ..block import HybridBlock
from ._rnn_impl import _GATES, rnn_layer_forward

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype="float32", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise _base.MXNetError(f"layout {layout!r}: expected 'TNC' or "
                                   "'NTC'")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        self._impl = "auto"  # ._rnn_impl.pick_impl; checks set 'step'
        gh, h = _GATES[mode] * hidden_size, hidden_size
        for li in range(num_layers):
            in_sz = input_size if li == 0 else h * self._dir
            for d in range(self._dir):
                pfx = ("l" if d == 0 else "r") + str(li)
                for nm, shape, init in (
                        ("i2h_weight", (gh, in_sz), i2h_weight_initializer),
                        ("h2h_weight", (gh, h), h2h_weight_initializer),
                        ("i2h_bias", (gh,), i2h_bias_initializer),
                        ("h2h_bias", (gh,), h2h_bias_initializer)):
                    self._new_param(f"{pfx}_{nm}", shape, dtype, init=init,
                                    allow_deferred_init=True)

    def infer_shape(self, x, *args):
        gh = _GATES[self._mode] * self._hidden_size
        for d in range(self._dir):
            self._set_shape(f"{'lr'[d]}0_i2h_weight", (gh, x.shape[2]))

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero initial states (NDArrays, (L·D, B, H); two for LSTM) on
        ``ctx`` (default: the current context)."""
        return [_ndmod.zeros(info["shape"], ctx=ctx, dtype=self._dtype)
                for info in self.state_info(batch_size)]

    def forward(self, x, states=None):
        """x (T, B, C) (``TNC``) or (B, T, C) (``NTC``) → the output, or
        (output, [h (, c)]) when ``states`` is given."""
        return_states = states is not None
        ntc = self._layout == "NTC"
        if states is None:
            batch = x.shape[0] if ntc else x.shape[1]
            states = [torch.zeros(info["shape"], dtype=x.dtype,
                                  device=x.device)
                      for info in self.state_info(batch)]
        elif isinstance(states, torch.Tensor):
            states = [states]
        n_dir, n = self._dir, len(states)
        # every weight in the layout order: per layer and direction,
        # i2h and h2h weights, then their biases
        names = [f"{'lr'[d]}{li}_{nm}" for li in range(self._num_layers)
                 for d in range(n_dir)
                 for nm in ("i2h_weight", "h2h_weight", "i2h_bias",
                            "h2h_bias")]
        x, *rest = _amp.cast("rnn_layer", x, *states,
                             *(getattr(self, nm) for nm in names))
        flat = rest[n:]
        params = [[tuple(flat[4 * (li * n_dir + d):4 * (li * n_dir + d + 1)])
                   for d in range(n_dir)] for li in range(self._num_layers)]
        out, h, c = rnn_layer_forward(
            x.transpose(0, 1) if ntc else x, params, rest[0],
            rest[1] if n == 2 else None, self._mode,
            p_dropout=self._dropout if _base.is_training() else 0.0,
            impl=self._impl)
        if ntc:
            out = out.transpose(0, 1)
        if not return_states:
            return out
        return out, ([h, c] if self._mode == "lstm" else [h])

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size} -> "
                f"{self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers})")


class RNN(_RNNLayer):
    """Elman RNN with ``activation`` 'relu' or 'tanh'."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__("rnn_" + activation, hidden_size, num_layers,
                         layout, dropout, bidirectional, input_size,
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
