"""INT8 quantization (counterpart of ``mxnet_tpu/contrib/quantization.py``).

The op surface keeps MXNet's contract (``quantize`` / ``quantize_v2`` /
``dequantize`` / ``requantize`` return (data, min, max) triples) and
``quantize_net`` swaps a Gluon net's ``Dense`` and ``Conv2D`` layers for
int8-weight ones, with activation ranges calibrated over a dataset
(naive min/max or the entropy/KL threshold) or taken per call.

Weights are quantized in numpy as the reference does, so ``qweight`` and
``wscale`` are the reference's bit for bit.  The int8 products
accumulate in int32 with ``torch._int_mm`` (int8 × int8 → int32; on the
card cuBLASLt's int8 GEMM), where the reference uses ``lax.dot_general``
/ ``lax.conv_general_dilated`` with ``preferred_element_type=int32``.
Torch's CUDA check of ``_int_mm`` wants more than 16 rows and inner and
output widths that are multiples of 8 (and a contiguous right operand,
which it otherwise reads wrong), so :func:`int8_matmul` pads both
operands with zeros, which is exact in integers, and slices the product
back; it pads the same way on the CPU, so the CPU tests run the card's
arithmetic.  A convolution is an im2col of the int8 input (a strided
view, copied once into the padded matrix) and one ``_int_mm`` a group.

No host read in a forward: a layer without a calibrated range quantizes
each input by its own max-abs, chosen on the device as the reference's
``jnp.where(jnp.isnan(crange[0]), dyn, calib)`` chooses it, so a
hybridized quantized net captures one CUDA graph whose range follows
every new input.  The epilogue is ``acc.float() * (x_scale * w_scale)``,
then the bias, then the layer's activation.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as onp
import torch
import torch.nn.functional as Fn

from .. import base as _base
from ..gluon.block import HybridBlock
from ..gluon.nn import Conv2D, Dense
from ..ndarray.ndarray import NDArray
from ..ndarray.ops import (ACTIVATION_FNS, CHANNELS_LAST_LAYOUTS, _as_nd,
                           invoke, pool)
from ..util import disable_jit

__all__ = ["quantize", "quantize_v2", "dequantize", "requantize",
           "calib_entropy_threshold", "quantize_net", "QuantizedDense",
           "QuantizedConv2D", "quantized_pooling"]


# ------------------------------------------------------------------- ops

def _div(t, c):
    """``t / c`` for a float constant ``c``, divided as the CPU and the
    reference divide: torch's CUDA kernels multiply by the reciprocal of
    a Python number instead, one bit off, and a scale one bit off moves
    an int8 value across a rounding boundary here and there."""
    return t / torch.full_like(t, c)


def _q_params(mn, mx, dtype):
    """Symmetric int8 / affine uint8 scale and zero from a float range."""
    if dtype == "int8":
        scale = _div(torch.clamp_min(torch.maximum(mn.abs(), mx.abs()),
                                     1e-8), 127.0)
        zero = torch.zeros_like(scale)
    elif dtype == "uint8":
        scale = _div(torch.clamp_min(mx - mn, 1e-8), 255.0)
        zero = torch.round(-mn / scale)
    else:
        raise _base.MXNetError(f"unsupported quantized dtype {dtype}")
    return scale, zero


def _affine_quantize(d, mn, mx, out_type):
    scale, zero = _q_params(mn, mx, out_type)
    lo, hi = (-127, 127) if out_type == "int8" else (0, 255)
    q = torch.clamp(torch.round(d / scale) + zero, lo, hi)
    return q.to(torch.int8 if out_type == "int8" else torch.uint8)


def _range(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def quantize(data, min_range, max_range, out_type="int8"):
    """(qdata, min, max): affine-quantize with an explicit range
    (``_contrib_quantize``)."""
    data = _as_nd(data)
    min_range, max_range = (_as_nd(x, data) for x in (min_range, max_range))

    def f(d, mn, mx):
        return _affine_quantize(d, mn.float(), mx.float(), out_type), mn, mx

    return invoke("quantize", f, [data, min_range, max_range],
                  differentiable=False)


def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """Auto-ranging quantize (``_contrib_quantize_v2``): the calibrated
    range where given, else the data's min and max."""
    data = _as_nd(data)

    def f(d):
        if min_calib_range is not None and max_calib_range is not None:
            mn, mx = _range(min_calib_range, d), _range(max_calib_range, d)
        else:
            mn, mx = d.min().float(), d.max().float()
        return _affine_quantize(d, mn, mx, out_type), mn, mx

    return invoke("quantize_v2", f, [data], differentiable=False)


def dequantize(qdata, min_range, max_range, out_type="float32"):
    """Inverse of :func:`quantize` (``_contrib_dequantize``)."""
    qdata = _as_nd(qdata)
    min_range, max_range = (_as_nd(x, qdata)
                            for x in (min_range, max_range))
    in_int8 = qdata._t.dtype == torch.int8

    def f(q, mn, mx):
        scale, zero = _q_params(mn.float(), mx.float(),
                                "int8" if in_int8 else "uint8")
        return ((q.float() - zero) * scale).to(_base.torch_dtype(out_type))

    return invoke("dequantize", f, [qdata, min_range, max_range],
                  differentiable=False)


def requantize(qdata, min_range, max_range, min_calib_range,
               max_calib_range):
    """int32 accumulators → int8 with a narrower calibrated range
    (``_contrib_requantize``)."""
    qdata = _as_nd(qdata)
    min_range, max_range = (_as_nd(x, qdata)
                            for x in (min_range, max_range))

    def f(q, mn, mx):
        in_scale = _div(torch.clamp_min(torch.maximum(mn.float().abs(),
                                                      mx.float().abs()),
                                        1e-8), 2.0 ** 31 - 1)
        cm, cx = _range(min_calib_range, q), _range(max_calib_range, q)
        out_scale, _ = _q_params(cm, cx, "int8")
        val = q.float() * in_scale
        out = torch.clamp(torch.round(val / out_scale), -127, 127)
        return out.to(torch.int8), cm, cx

    return invoke("requantize", f, [qdata, min_range, max_range],
                  differentiable=False)


# --------------------------------------------------------- int8 products

def _ceil8(n):
    return -(-n // 8) * 8


def int8_matmul(xq: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 by (Kp, Np) int8 → (M, Np) int32 through
    ``torch._int_mm``.  ``wt`` comes from :func:`padded_weight` (K and N
    already padded to multiples of 8, contiguous); ``xq``'s K is padded
    to ``wt``'s, and fewer than 17 rows to 32, with zeros."""
    m, k = xq.shape
    kp = wt.shape[0]
    mp = m if m > 16 else 32
    if (mp, kp) != (m, k) or not xq.is_contiguous():
        xq = Fn.pad(xq, (0, kp - k, 0, mp - m)).contiguous()
    if xq.is_cuda:
        int8_matmul.calls += 1
    acc = torch._int_mm(xq, wt)
    return acc if mp == m else acc[:m]


int8_matmul.calls = 0     # _int_mm calls on CUDA tensors (replays not seen)


def padded_weight(wq: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 weights as the contiguous (Kp, Np) right operand of
    :func:`int8_matmul`, zero-padded to multiples of 8."""
    n, k = wq.shape
    return Fn.pad(wq, (0, _ceil8(k) - k, 0, _ceil8(n) - n)).t().contiguous()


def _x_scale(x, crange):
    """The activations' scale: their own max-abs where the calibrated
    range is NaN (none), else the range's; chosen on the device."""
    dyn = torch.clamp_min(x.abs().amax(), 1e-8)
    calib = torch.maximum(crange[0].abs(), crange[1].abs())
    return _div(torch.where(torch.isnan(crange[0]), dyn, calib), 127.0)


def _quantize_acts(x, x_scale):
    return torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)


# ------------------------------------------------------------ calibration

def calib_entropy_threshold(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence-optimal |threshold| from an absolute-value histogram
    (the entropy mode of upstream's calibration,
    ``get_optimal_threshold``)."""
    hist = onp.asarray(hist, onp.float64)
    edges = onp.asarray(hist_edges)
    nbins = len(hist)
    csum = onp.concatenate([[0.0], onp.cumsum(hist)])
    total = csum[-1]
    best_kl, best_t = onp.inf, edges[-1]
    start = max(num_quantized_bins // 2, 1)
    for i in range(start, nbins + 1):
        if total == 0:
            continue
        # candidate p: hist[:i] with the tail folded into its last bin
        p_last = hist[i - 1] + (total - csum[i])
        p_sum = total
        # hist[:i] merged into num_quantized_bins segments
        idx = onp.linspace(0, i, num_quantized_bins + 1).astype(int)
        idx_hi = onp.maximum(idx[1:], idx[:-1] + 1)
        seg_sum = csum[onp.minimum(idx_hi, i)] - csum[idx[:-1]]
        nz_csum = onp.concatenate([[0], onp.cumsum(hist[:i] > 0)])
        seg_nz = nz_csum[onp.minimum(idx_hi, i)] - nz_csum[idx[:-1]]
        # expanded back: each nonzero bin of a segment gets its mean
        seg_of = onp.searchsorted(idx[1:], onp.arange(i), side="right")
        seg_of = onp.minimum(seg_of, num_quantized_bins - 1)
        with onp.errstate(divide="ignore", invalid="ignore"):
            fill = onp.where(seg_nz > 0, seg_sum / onp.maximum(seg_nz, 1),
                             0.0)
        q = onp.where(hist[:i] > 0, fill[seg_of], 0.0)
        qs = q.sum()
        if qs == 0:
            continue
        pm = hist[:i] / p_sum
        pm_last = p_last / p_sum
        qm = q / qs
        mask = hist[:i] > 0
        pm_eff = pm.copy()
        pm_eff[-1] = pm_last
        mask[-1] = pm_last > 0
        kl = float((pm_eff[mask] * onp.log(
            pm_eff[mask] / onp.maximum(qm[mask], 1e-12))).sum())
        if kl < best_kl:
            best_kl, best_t = kl, edges[i]
    return float(best_t)


class _Collector:
    """Per-layer activation statistics over the calibration batches, on
    host numpy: min and max, and for ``entropy`` an |x| histogram."""

    def __init__(self, mode, num_bins=8001):
        self.mode = mode
        self.num_bins = num_bins
        self.minmax: Dict[str, List[float]] = {}
        self.hists: Dict[str, onp.ndarray] = {}
        self.hist_max: Dict[str, float] = {}

    def collect(self, name, arr):
        a = onp.asarray(arr)
        mn, mx = float(a.min()), float(a.max())
        if name in self.minmax:
            self.minmax[name][0] = min(self.minmax[name][0], mn)
            self.minmax[name][1] = max(self.minmax[name][1], mx)
        else:
            self.minmax[name] = [mn, mx]
        if self.mode == "entropy":
            amax = max(abs(mn), abs(mx), 1e-8)
            if name not in self.hists or amax > self.hist_max[name]:
                # a wider range re-bins what was counted so far
                old_h = self.hists.get(name)
                old_m = self.hist_max.get(name, amax)
                self.hist_max[name] = amax = max(amax, old_m)
                self.hists[name] = onp.zeros(self.num_bins)
                if old_h is not None:
                    centers = (onp.arange(self.num_bins) + 0.5) * \
                        old_m / self.num_bins
                    reb, _ = onp.histogram(centers, bins=self.num_bins,
                                           range=(0, amax), weights=old_h)
                    self.hists[name] += reb
            h, _ = onp.histogram(onp.abs(a), bins=self.num_bins,
                                 range=(0, self.hist_max[name]))
            self.hists[name] += h

    def ranges(self):
        out = {}
        for name, (mn, mx) in self.minmax.items():
            if self.mode == "entropy" and name in self.hists:
                edges = onp.linspace(0, self.hist_max[name],
                                     self.num_bins + 1)
                t = calib_entropy_threshold(self.hists[name], edges)
                out[name] = (-t if mn < 0 else 0.0, t)
            else:
                out[name] = (mn, mx)
        return out


# ------------------------------------------------------------ layers/net

class _Quantized(HybridBlock):
    """int8 weights, their scale, the bias and the calibrated activation
    range as frozen parameters (named as the reference's), so a
    quantized net saves and loads whole through ``save_parameters``."""

    def _freeze(self, name, value: onp.ndarray, device):
        self.register_parameter(name, torch.nn.Parameter(
            torch.from_numpy(onp.ascontiguousarray(value)).to(device),
            requires_grad=False))

    def _setup(self, layer, wq, w_scale, min_calib, max_calib):
        dev = layer.weight.device
        self._freeze("qweight", wq, dev)
        self._freeze("wscale", onp.asarray(w_scale, onp.float32), dev)
        # NaN: no calibration, each input quantizes by its own range
        self._freeze("acts_range", onp.array(
            [float("nan") if min_calib is None else min_calib,
             float("nan") if max_calib is None else max_calib],
            onp.float32), dev)
        if layer.bias is not None:
            self._freeze("bias", layer.bias.detach().float().cpu().numpy(),
                         dev)
        else:
            self.bias = None
        self._activation = layer._activation
        self._act = ACTIVATION_FNS[self._activation] \
            if self._activation else None
        self._wt = None         # (qweight it came from, its version, wt)

    def _operand(self, build):
        """``build(qweight)``, the int8 weights as ``_int_mm``'s right
        operand, rebuilt when ``qweight`` is replaced or written (a
        load)."""
        q = self.qweight
        if self._wt is None or self._wt[0] is not q \
                or self._wt[1] != q._version:
            self._wt = (q, q._version, build(q))
        return self._wt[2]

    def _epilogue(self, acc, scale):
        out = acc.float() * scale
        if self.bias is not None:
            out = out + self.bias
        return out if self._act is None else self._act(out)


class QuantizedDense(_Quantized):
    """int8-weight ``Dense`` (``_contrib_quantized_fully_connected``):
    activations quantize by their calibrated range or per call, the
    product accumulates in int32 (:func:`int8_matmul`), the float32
    epilogue applies the scales and the bias."""

    def __init__(self, dense: Dense, min_calib=None, max_calib=None,
                 **kwargs):
        super().__init__(**kwargs)
        wnp = dense.weight.detach().float().cpu().numpy()
        w_scale = float(max(abs(wnp.min()), abs(wnp.max()), 1e-8)) / 127.0
        wq = onp.clip(onp.round(wnp / w_scale), -127, 127).astype(onp.int8)
        self._setup(dense, wq, [w_scale], min_calib, max_calib)
        self._units = dense._units
        self._flatten = dense._flatten

    def forward(self, x):
        with torch.no_grad():
            if self._flatten and x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            lead = x.shape[:-1]
            x = x.reshape(-1, x.shape[-1])
            x_scale = _x_scale(x, self.acts_range)
            acc = int8_matmul(_quantize_acts(x, x_scale),
                              self._operand(padded_weight))
            out = self._epilogue(acc[:, :self._units],
                                 x_scale * self.wscale[0])
            return out.reshape(*lead, self._units)

    def __repr__(self):
        return (f"QuantizedDense({self.qweight.shape[1]} -> "
                f"{self._units}, int8)")


class QuantizedConv2D(_Quantized):
    """int8-weight NCHW ``Conv2D`` (``_contrib_quantized_conv``):
    per-output-channel weight scales, int32 accumulation by im2col and
    :func:`int8_matmul` a group (the reference's strides, padding,
    dilation and groups), float32 scale and bias epilogue.  The
    reference reads data as NCHW and weights as OIHW; a channels-last
    ``Conv2D`` is refused."""

    def __init__(self, conv, min_calib=None, max_calib=None, **kwargs):
        super().__init__(**kwargs)
        if conv._layout in CHANNELS_LAST_LAYOUTS or conv._layout != "NCHW":
            raise _base.MXNetError(
                f"QuantizedConv2D runs NCHW data with OIHW weights, as "
                f"the reference's int8 convolution does; this Conv2D has "
                f"layout {conv._layout!r} (build the net with "
                f"layout='NCHW' to quantize it)")
        wnp = conv.weight.detach().float().cpu().numpy()   # (O, I/g, kH, kW)
        # per-output-channel symmetric scales
        absmax = onp.maximum(onp.abs(wnp).reshape(wnp.shape[0], -1)
                             .max(axis=1), 1e-8)
        w_scale = (absmax / 127.0).astype(onp.float32)
        wq = onp.clip(onp.round(wnp / w_scale[:, None, None, None]),
                      -127, 127).astype(onp.int8)
        self._setup(conv, wq, w_scale, min_calib, max_calib)
        self._strides = conv._strides
        self._padding = conv._padding
        self._dilation = conv._dilation
        self._groups = conv._groups
        self._channels = conv._channels
        self._kernel = conv._kernel

    def _group_weights(self, q):
        """Each group's (O/g, I/g·kH·kW) weights as a padded operand."""
        per = q.shape[0] // self._groups
        return [padded_weight(q[g * per:(g + 1) * per].reshape(per, -1))
                for g in range(self._groups)]

    def forward(self, x):
        with torch.no_grad():
            x_scale = _x_scale(x, self.acts_range)
            xq = _quantize_acts(x, x_scale)
            (sh, sw), (ph, pw) = self._strides, self._padding
            (dh, dw), (kh, kw) = self._dilation, self._kernel
            if ph or pw:
                xq = Fn.pad(xq, (pw, pw, ph, ph))
            n, c, h, w = xq.shape
            ho = (h - dh * (kh - 1) - 1) // sh + 1
            wo = (w - dw * (kw - 1) - 1) // sw + 1
            cg = c // self._groups
            s_n, s_c, s_h, s_w = xq.stride()
            accs = []
            for g, wt in enumerate(self._operand(self._group_weights)):
                # im2col: (N, Ho, Wo, Cg, kH, kW) as a strided view of
                # the padded int8 input, copied once into the matrix
                cols = xq.as_strided(
                    (n, ho, wo, cg, kh, kw),
                    (s_n, s_h * sh, s_w * sw, s_c, s_h * dh, s_w * dw),
                    xq.storage_offset() + g * cg * s_c)
                k = cg * kh * kw
                mat = torch.zeros((n * ho * wo, wt.shape[0]),
                                  dtype=torch.int8, device=xq.device)
                mat[:, :k].view(n, ho, wo, cg, kh, kw).copy_(cols)
                accs.append(int8_matmul(mat, wt)[:, :self._channels
                                                 // self._groups])
            acc = accs[0] if len(accs) == 1 else torch.cat(accs, dim=1)
            out = self._epilogue(acc, x_scale * self.wscale)
            # (N·Ho·Wo, O) → NCHW (channels-last in memory)
            return out.reshape(n, ho, wo, -1).permute(0, 3, 1, 2)

    def __repr__(self):
        return f"QuantizedConv2D({self._channels} ch, int8)"


def quantized_pooling(qdata, min_range, max_range, kernel=None, stride=None,
                      pad=None, pool_type="max", global_pool=False):
    """Pooling on int8 data keeping the (q, min, max) triple
    (``_contrib_quantized_pooling``).  Max pooling preserves order, so
    it pools the int8 values (exact in float32); average pooling sums in
    float32 and rounds back to the same scale."""
    qdata = _as_nd(qdata)
    min_range, max_range = (_as_nd(x, qdata)
                            for x in (min_range, max_range))
    if pool_type not in ("max", "avg"):
        raise _base.MXNetError(f"unsupported pool_type {pool_type}")

    def f(q):
        y = pool(q.float(), kernel=kernel, pool_type=pool_type,
                 global_pool=global_pool, stride=stride, pad=pad)
        if pool_type == "avg":
            y = torch.clamp(torch.round(y), -127, 127)
        return y.to(torch.int8)

    return invoke("quantized_pooling", f, [qdata],
                  differentiable=False), min_range, max_range


def _batch_data(batch):
    """A calibration batch's input: a DataBatch's first data array, or
    the batch itself (an NDArray or a tensor, whose ``.data`` is not a
    DataBatch's list)."""
    if isinstance(batch, (NDArray, torch.Tensor)):
        return batch
    return batch.data[0] if hasattr(batch, "data") else batch


def quantize_net(net, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 num_calib_batches=None):
    """Swap the ``Dense`` and ``Conv2D`` layers of a Gluon net for int8
    ones, in place (``contrib.quantization.quantize_net``).

    ``calib_mode``: ``'none'`` (each input quantizes by its own range),
    ``'naive'`` (min/max over ``calib_data``) or ``'entropy'`` (the
    KL-optimal thresholds).  ``calib_data`` yields input batches
    (NDArrays, tensors or DataBatches).  ``exclude_layers`` names layers
    by structural path (``'0'``, ``'blocks.3.attn.q_proj'``).  The
    calibration forwards run imperatively, hybridized blocks included:
    the statistics are read on the host, through torch forward pre-hooks
    removed by their handles afterwards."""
    if quantized_dtype != "int8":
        raise _base.MXNetError(
            f"quantized_dtype {quantized_dtype!r}: the port's int8 "
            "products accumulate int8 x int8 in int32 (torch._int_mm), "
            "so it quantizes to 'int8' only")
    exclude = set(exclude_layers or ())
    calib_iter = iter(calib_data) if calib_data is not None else None
    first_batch = next(calib_iter, None) if calib_iter is not None else None

    def walk(block, prefix=""):
        for name, child in list(block._modules.items()):
            path = f"{prefix}{name}"
            if isinstance(child, (Dense, Conv2D)) and path not in exclude:
                if child.weight.device.type != "meta":
                    targets.append((block, name, path, child))
                else:
                    deferred.append(path)
            else:
                walk(child, path + ".")

    targets, deferred = [], []
    walk(net)
    with disable_jit():
        if deferred and first_batch is not None:
            # one forward settles the deferred shapes; then walk again
            net(_batch_data(first_batch))
            targets, deferred = [], []
            walk(net)
        if deferred:
            raise _base.MXNetError(
                f"Dense/Conv2D layers {deferred} have uninitialized "
                "(deferred) weights: run a forward pass or pass "
                "calib_data so quantize_net can see their shapes")
        ranges: Dict[str, tuple] = {}
        if calib_data is not None and calib_mode in ("naive", "entropy"):
            collector = _Collector(calib_mode)

            def hook_for(path):
                def hook(block, inputs):        # torch's hooks see tensors
                    collector.collect(
                        path, inputs[0].detach().float().cpu().numpy())
                return hook

            handles = [layer.register_forward_pre_hook(hook_for(path))
                       for _p, _a, path, layer in targets]
            try:
                batches = itertools.chain(
                    [first_batch] if first_batch is not None else [],
                    calib_iter)
                for n, batch in enumerate(batches, 1):
                    net(_batch_data(batch))
                    if num_calib_batches is not None and \
                            n >= num_calib_batches:
                        break
            finally:
                for h in handles:
                    h.remove()
            ranges = collector.ranges()

    for parent, attr, path, layer in targets:
        r = ranges.get(path)
        cls = QuantizedDense if isinstance(layer, Dense) else QuantizedConv2D
        parent.register_child(cls(layer, min_calib=r[0] if r else None,
                                  max_calib=r[1] if r else None), attr)
    for m in net.modules():
        if hasattr(m, "_clear_cached_op"):
            m._clear_cached_op()
    return net
