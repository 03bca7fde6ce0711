"""Multi-layer RNN compute (counterpart of
``mxnet_tpu/gluon/rnn/_rnn_impl.py``; parity target MXNet's
``src/operator/rnn.cc`` / cuDNN RNN).

Two routes compute one function, layer by layer:

- ``step``, the reference's decomposition: one input-projection GEMM
  over every step of a layer and direction, then a loop of
  (B, H) x (H, G·H) products and the gate math.  Any device; the CPU
  takes it.
- ``fused``, torch's recurrent op (``torch._VF.lstm`` / ``gru`` /
  ``rnn_tanh`` / ``rnn_relu``), which on a CUDA tensor is cuDNN: one
  call per layer, both directions in it.

Gate orders are MXNet's, which are also torch's and cuDNN's: LSTM
[i, f, g, o], GRU [r, z, n] with ``n = tanh(x_n + r · (h W_hn + b_hn))``.
Dropout between layers (training only) is drawn from the device's
generator (:mod:`mxnet_tpu_torch.random`) in both routes, so one seed
gives one set of masks whichever route runs.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import torch

from ... import base as _base
from ... import random as _random
from ...ndarray.ops import _as_nd, invoke

__all__ = ["rnn_layer_forward", "rnn_forward", "unpack_params"]

# gates per mode; each mode names its torch._VF op too
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

# (w_ih, w_hh, b_ih, b_hh) of one layer and direction
Weights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _cell_scan(mode, x_proj, h0, c0, w_hh, b_hh, reverse=False):
    """One layer and direction: ``x_proj`` (T, B, G·H) input projections
    (bias included), the recurrence one (B, H) x (H, G·H) product a
    step.  Returns (outputs (T, B, H), last h, last c or None)."""
    h, c = h0, c0
    steps = range(x_proj.shape[0])
    ys: List[Optional[torch.Tensor]] = [None] * len(steps)
    for t in (reversed(steps) if reverse else steps):
        hp = torch.addmm(b_hh, h, w_hh.t())
        if mode == "lstm":
            i, f, g, o = (x_proj[t] + hp).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            xr, xz, xn = x_proj[t].chunk(3, dim=-1)
            hr, hz, hn = hp.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
        else:
            pre = x_proj[t] + hp
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        ys[t] = h
    return torch.stack(ys), h, (c if mode == "lstm" else None)


def _step_layer(mode, x, dirs: Sequence[Weights], h0, c0):
    """One layer by the step route: (T, B, C) → (T, B, D·H) and the
    last states (D, B, H)."""
    outs, hs, cs = [], [], []
    for d, (w_ih, w_hh, b_ih, b_hh) in enumerate(dirs):
        xp = torch.matmul(x, w_ih.t()) + b_ih
        ys, h, c = _cell_scan(mode, xp, h0[d], None if c0 is None else c0[d],
                              w_hh, b_hh, reverse=d == 1)
        outs.append(ys)
        hs.append(h)
        cs.append(c)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return out, torch.stack(hs), (torch.stack(cs) if mode == "lstm"
                                  else None)


def _fused_layer(mode, x, dirs: Sequence[Weights], h0, c0):
    """One layer by torch's recurrent op (cuDNN on a CUDA tensor)."""
    flat = [w for ws in dirs for w in ws]
    fn = getattr(torch._VF, mode)
    # cuDNN keeps the buffers its backward needs only in training mode
    train = torch.is_grad_enabled()
    with warnings.catch_warnings():
        # the weights are separate parameters, as in the reference's
        # layer, so cuDNN packs them at each call and says so
        warnings.filterwarnings("ignore", message=".*contiguous chunk.*")
        if mode == "lstm":
            out, h, c = fn(x, (h0, c0), flat, True, 1, 0.0, train,
                           len(dirs) == 2, False)
            return out, h, c
        out, h = fn(x, h0, flat, True, 1, 0.0, train, len(dirs) == 2,
                    False)
    return out, h, None


def pick_impl(impl: str, x: torch.Tensor) -> str:
    """``'auto'`` is ``'fused'`` for a CUDA tensor, ``'step'`` else."""
    if impl not in ("auto", "fused", "step"):
        raise _base.MXNetError(f"impl={impl!r}: expected 'auto', 'fused' "
                               "or 'step'")
    if impl == "auto":
        return "fused" if x.device.type == "cuda" else "step"
    return impl


def rnn_layer_forward(x, params_per_dir, h0s, c0s, mode, p_dropout=0.0,
                      impl="auto"):
    """x (T, B, C); ``params_per_dir`` a list over layers of a list over
    directions of (w_ih, w_hh, b_ih, b_hh); h0s/c0s (L·D, B, H).
    Dropout ``p_dropout`` after every layer but the last (the caller
    passes 0 outside training).  Returns (out (T, B, D·H), h (L·D, B,
    H), c or None)."""
    layer = _fused_layer if pick_impl(impl, x) == "fused" else _step_layer
    n_dir = len(params_per_dir[0])
    if mode == "lstm" and c0s is None:
        c0s = torch.zeros_like(h0s)
    out, hs, cs = x, [], []
    for li, dirs in enumerate(params_per_dir):
        sl = slice(li * n_dir, (li + 1) * n_dir)
        out, h, c = layer(mode, out, dirs, h0s[sl].contiguous(),
                          None if c0s is None else c0s[sl].contiguous())
        hs.append(h)
        cs.append(c)
        if p_dropout > 0 and li < len(params_per_dir) - 1:
            draw = torch.rand(out.shape, device=out.device,
                              generator=_random.generator(out.device))
            out = torch.where(draw < 1 - p_dropout, out / (1 - p_dropout),
                              torch.zeros_like(out))
    return out, torch.cat(hs), (torch.cat(cs) if mode == "lstm" else None)


def unpack_params(flat, input_size, state_size, num_layers, n_dir, mode):
    """MXNet's (and cuDNN's) flat parameter vector → a list over layers
    of a list over directions of (w_ih, w_hh, b_ih, b_hh): every weight
    first (layer-major, i2h then h2h per layer and direction), then
    every bias in the same order."""
    gh = _GATES[mode] * state_size
    need = sum(n_dir * gh * ((input_size if li == 0 else state_size * n_dir)
                             + state_size + 2)
               for li in range(num_layers))
    if need != flat.numel():
        raise _base.MXNetError(f"RNN parameters: {flat.numel()} values, "
                               f"the layout needs {need}")
    pos = 0

    def take(n, shape):
        nonlocal pos
        out = flat[pos:pos + n].reshape(shape)
        pos += n
        return out

    weights = []
    for li in range(num_layers):
        in_sz = input_size if li == 0 else state_size * n_dir
        for _ in range(n_dir):
            weights.append((take(gh * in_sz, (gh, in_sz)),
                            take(gh * state_size, (gh, state_size))))
    biases = [(take(gh, (gh,)), take(gh, (gh,)))
              for _ in range(num_layers * n_dir)]
    return [[weights[li * n_dir + d] + biases[li * n_dir + d]
             for d in range(n_dir)] for li in range(num_layers)]


def rnn_forward(data, parameters, state, state_cell, state_size, num_layers,
                mode, bidirectional, p, state_outputs):
    """Backs ``nd.RNN``: (T, B, C) data, the flat parameter vector, the
    (L·D, B, H) initial state (and cell state for LSTM).  Returns the
    output, or [output, h (, c)] with ``state_outputs``."""
    if mode not in _GATES:
        raise _base.MXNetError(f"RNN mode {mode!r}: expected one of "
                               f"{sorted(_GATES)}")
    data = _as_nd(data)
    nds = [data, _as_nd(parameters, data), _as_nd(state, data)]
    if mode == "lstm" and state_cell is not None:
        nds.append(_as_nd(state_cell, data))
    n_dir = 2 if bidirectional else 1
    p_drop = p if (_base.is_training() and num_layers > 1) else 0.0

    def f(x, flat, h0, *rest):
        params = unpack_params(flat, x.shape[-1], state_size, num_layers,
                               n_dir, mode)
        out, h, c = rnn_layer_forward(x, params, h0,
                                      rest[0] if rest else None, mode,
                                      p_dropout=p_drop)
        return (out, h, c) if mode == "lstm" else (out, h)

    res = invoke("RNN", f, nds)
    return res if state_outputs else res[0]
