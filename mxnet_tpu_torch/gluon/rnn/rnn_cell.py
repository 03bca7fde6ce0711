"""Per-step recurrent cells (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``).

A cell's ``forward(inputs, states)`` takes one step: (B, C) inputs and
the list of its states, each (B, ·), and returns (output, new states),
as tensors or, through the Block's NDArray convention, NDArrays.
:meth:`RecurrentCell.unroll` runs it over a sequence (a (B, T, C) /
(T, B, C) array or a list of (B, C) steps).  Parameter names are the
reference's (``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``,
LSTMP's ``h2r_weight``); ``input_size=0`` defers ``i2h_weight`` to the
first step.  Random masks (zoneout, variational dropout) come from the
device's generator in :mod:`mxnet_tpu_torch.random`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import base as _base
from ... import random as _random
from ...ndarray import ndarray as _ndmod
from ...ndarray.ndarray import NDArray
from ...ndarray.ops import ACTIVATION_FNS
from ..block import HybridBlock, _unwrap, _wrap

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
           "ModifierCell", "ResidualCell", "ZoneoutCell",
           "BidirectionalCell", "VariationalDropoutCell", "LSTMPCell"]


def _keep(rate, like):
    """A 0/1 float mask like ``like``, each element 1 with probability
    ``1 - rate``."""
    draw = torch.rand(like.shape, device=like.device,
                      generator=_random.generator(like.device))
    return (draw < 1 - rate).to(like.dtype)


def _unrolled(inputs, length, layout, merge_outputs, run):
    """``run(steps)`` → (outputs, states) over the sequence as a list of
    its ``length`` (B, C) tensor steps; the outputs stacked on the time
    axis with ``merge_outputs``.  NDArray inputs give NDArrays back and
    build a graph only while recording, as the Block convention does."""
    nd_in = any(isinstance(x, NDArray) for x in
                (inputs if isinstance(inputs, (list, tuple)) else [inputs]))
    axis = layout.find("T")
    with torch.set_grad_enabled(_base.is_recording() if nd_in
                                else torch.is_grad_enabled()):
        inputs = _unwrap(inputs)
        steps = list(inputs) if isinstance(inputs, (list, tuple)) else \
            list(inputs.unbind(axis))[:length]
        outputs, states = run(steps)
        if merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
    return (_wrap(outputs), _wrap(states)) if nd_in else (outputs, states)


class RecurrentCell(HybridBlock):
    """Base of the cells: ``state_info``, ``begin_state``, ``reset`` and
    ``unroll``."""

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states (NDArrays) on ``ctx`` (default: the current
        context)."""
        return [_ndmod.zeros(info["shape"], ctx=ctx)
                for info in self.state_info(batch_size)]

    def reset(self):
        """Forget per-sequence state (masks, the previous output)."""

    def _zero_states(self, like):
        b = like.shape[0]
        return [torch.zeros(info["shape"], dtype=like.dtype,
                            device=like.device)
                for info in self.state_info(b)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` ((B, T, C) for ``NTC``,
        (T, B, C) for ``TNC``, or a list of (B, C) steps).  Returns
        (outputs — a list of steps, or one array stacked on the time
        axis with ``merge_outputs`` — and the last states)."""
        self.reset()    # per-sequence state never leaks across unrolls

        def run(steps):
            states = (_unwrap(list(begin_state)) if begin_state is not None
                      else self._zero_states(steps[0]))
            outputs = []
            for x in steps[:length]:
                out, states = self(x, states)
                outputs.append(out)
            return outputs, states
        return _unrolled(inputs, length, layout, merge_outputs, run)


class _GatedCell(RecurrentCell):
    """A cell of ``gates`` blocks of ``hidden_size`` over i2h and h2h
    projections (h2h from a recurrent state ``rec_size`` wide)."""

    def __init__(self, gates, hidden_size, input_size, rec_size,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._gates = gates
        gh = gates * hidden_size
        self._new_param("i2h_weight", (gh, input_size),
                        init=i2h_weight_initializer,
                        allow_deferred_init=True)
        self._new_param("h2h_weight", (gh, rec_size),
                        init=h2h_weight_initializer,
                        allow_deferred_init=True)
        self._new_param("i2h_bias", (gh,), init=i2h_bias_initializer,
                        allow_deferred_init=True)
        self._new_param("h2h_bias", (gh,), init=h2h_bias_initializer,
                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self._set_shape("i2h_weight", (self._gates * self._hidden_size,
                                       x.shape[-1]))

    def _i2h(self, x):
        return F.linear(x, self.i2h_weight, self.i2h_bias)

    def _h2h(self, h):
        return F.linear(h, self.h2h_weight, self.h2h_bias)


class RNNCell(_GatedCell):
    """Elman cell: ``h = act(x W_i2hᵀ + b_i2h + h W_h2hᵀ + b_h2h)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(1, hidden_size, input_size, hidden_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer, prefix,
                         params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def forward(self, inputs, states):
        out = ACTIVATION_FNS[self._activation](self._i2h(inputs) +
                                               self._h2h(states[0]))
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM cell, gates [i, f, g, o]; states [h, c]."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(4, hidden_size, input_size, hidden_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer, prefix,
                         params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}] * 2

    def _cell(self, inputs, states):
        i, f, g, o = (self._i2h(inputs) + self._h2h(states[0])) \
            .chunk(4, dim=-1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def forward(self, inputs, states):
        h, c = self._cell(inputs, states)
        return h, [h, c]


class GRUCell(_GatedCell):
    """GRU cell, gates [r, z, n], ``n = tanh(x_n + r · h2h_n)``."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(3, hidden_size, input_size, hidden_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer, prefix,
                         params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def forward(self, inputs, states):
        xr, xz, xn = self._i2h(inputs).chunk(3, dim=-1)
        hr, hz, hn = self._h2h(states[0]).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class LSTMPCell(LSTMCell):
    """LSTM with a projected recurrent state (Sak et al. 2014): the cell
    state is ``hidden_size`` wide, the output and recurrent state
    ``projection_size`` (``r = h W_h2rᵀ``); states [r, c]."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        _GatedCell.__init__(self, 4, hidden_size, input_size,
                            projection_size, i2h_weight_initializer,
                            h2h_weight_initializer, i2h_bias_initializer,
                            h2h_bias_initializer, prefix, params)
        self._projection_size = projection_size
        self._new_param("h2r_weight", (projection_size, hidden_size),
                        init=h2r_weight_initializer,
                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def forward(self, inputs, states):
        h, c = self._cell(inputs, states)
        r = F.linear(h, self.h2r_weight)
        return r, [r, c]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its own
    slice of the states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for c in self._modules.values()
                for info in c.state_info(batch_size)]

    def reset(self):
        for c in self._modules.values():
            c.reset()

    def forward(self, inputs, states):
        next_states, pos = [], 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[pos:pos + n])
            next_states.extend(st)
            pos += n
        return inputs, next_states

    def __len__(self):
        return len(self._modules)


# the reference's hybridizable alias: the same cell here
HybridSequentialRNNCell = SequentialRNNCell


class DropoutCell(RecurrentCell):
    """Dropout on the inputs of each step (training only); no state."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0 and _base.is_training():
            inputs = inputs * _keep(self._rate, inputs) / (1 - self._rate)
        return inputs, states


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap ``base_cell`` (residual, zoneout,
    variational dropout)."""

    def __init__(self, base_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def reset(self):
        self.base_cell.reset()


class ResidualCell(ModifierCell):
    """``base_cell``'s output plus its input."""

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al. 2016): in training each output element
    keeps the previous step's value with probability
    ``zoneout_outputs``, each state element its previous value with
    probability ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 prefix=None, params=None):
        super().__init__(base_cell, prefix=prefix, params=params)
        self._zo, self._zs = zoneout_outputs, zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        if _base.is_training():
            if self._zo > 0:
                mask = _keep(self._zo, out)
                prev = self._prev_output if self._prev_output is not None \
                    else torch.zeros_like(out)
                out = mask * out + (1 - mask) * prev
            if self._zs > 0:
                new_states = [m * ns + (1 - m) * s for ns, s, m in
                              ((ns, s, _keep(self._zs, ns))
                               for ns, s in zip(new_states, states))]
        self._prev_output = out
        return out, new_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed,
    their outputs concatenated per step; only :meth:`unroll` runs it."""

    def __init__(self, l_cell, r_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def reset(self):
        self.l_cell.reset()
        self.r_cell.reset()

    def forward(self, inputs, states):
        raise NotImplementedError("BidirectionalCell cannot be stepped; "
                                  "call unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        nl = len(self.l_cell.state_info())

        def run(steps):
            states = (_unwrap(list(begin_state)) if begin_state is not None
                      else self._zero_states(steps[0]))
            l_out, l_st = self.l_cell.unroll(length, steps, states[:nl],
                                             merge_outputs=False)
            r_out, r_st = self.r_cell.unroll(length, steps[::-1],
                                             states[nl:],
                                             merge_outputs=False)
            return ([torch.cat([lo, ro], dim=-1)
                     for lo, ro in zip(l_out, reversed(r_out))],
                    list(l_st) + list(r_st))
        return _unrolled(inputs, length, layout, merge_outputs, run)


class VariationalDropoutCell(ModifierCell):
    """Variational dropout (Gal and Ghahramani 2016): one mask per
    sequence for the inputs, the first state and the outputs, reused at
    every step until :meth:`reset` (which ``unroll`` calls)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, prefix=None, params=None):
        super().__init__(base_cell, prefix=prefix, params=params)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self._mask_i = self._mask_s = self._mask_o = None

    def reset(self):
        super().reset()
        self._mask_i = self._mask_s = self._mask_o = None

    @staticmethod
    def _mask(rate, like):
        return _keep(rate, like) / (1 - rate)

    def forward(self, inputs, states):
        train = _base.is_training()
        if train and self._di > 0:
            if self._mask_i is None:
                self._mask_i = self._mask(self._di, inputs)
            inputs = inputs * self._mask_i
        if train and self._ds > 0:
            if self._mask_s is None:
                self._mask_s = self._mask(self._ds, states[0])
            states = [states[0] * self._mask_s] + list(states[1:])
        out, new_states = self.base_cell(inputs, states)
        if train and self._do > 0:
            if self._mask_o is None:
                self._mask_o = self._mask(self._do, out)
            out = out * self._mask_o
        return out, new_states
