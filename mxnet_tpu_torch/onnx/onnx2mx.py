"""onnx2mx: import an ONNX model and run it with torch ops (counterpart
of ``mxnet_tpu/onnx/onnx2mx.py``).

The imported graph runs node by node as torch ops on the block's device,
over the vocabulary the reference's importer takes (the ops both
packages' exporters emit, plus common basics).  It is also the in-repo
check of an export, since no onnxruntime is installed.
"""
from __future__ import annotations

from typing import Dict

import numpy as onp
import torch
import torch.nn.functional as Fn

from .. import base as _base
from ..context import resolve_device
from ..ndarray import NDArray
from . import proto

__all__ = ["ONNXBlock", "import_model"]


def _ints(x):
    return [int(v) for v in x.reshape(-1).tolist()]


def _spatial_pads(pads, n):
    """ONNX pads (begins..., ends...) over the ``n`` spatial dims as
    ``F.pad``'s (last dim first) pairs."""
    pads = list(pads or [0] * 2 * n)
    out = []
    for i in reversed(range(n)):
        out += [pads[i], pads[n + i]]
    return out


def _symmetric(pads, n):
    pads = list(pads or [0] * 2 * n)
    return pads[:n] == pads[n:], pads[:n]


class _Evaluator:
    def __init__(self, model, device):
        self.graph = model["graph"]
        self.opset = model["opset"]
        self.device = device
        self.consts = {k: torch.from_numpy(onp.array(v)).to(device)
                       for k, v in self.graph["initializers"].items()}

    def run(self, feeds: Dict[str, torch.Tensor]):
        env = dict(self.consts)
        env.update(feeds)
        for nd in self.graph["nodes"]:
            outs = self.op(nd, [env[i] for i in nd["inputs"] if i])
            if not isinstance(outs, (tuple, list)):
                outs = [outs]
            for name, val in zip(nd["outputs"], outs):
                env[name] = val
        return [env[name] for name, _, _ in self.graph["outputs"]]

    def op(self, nd, x):
        op = nd["op"]
        a = nd["attrs"]
        ew = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
              "Div": torch.true_divide, "Pow": torch.pow, "Exp": torch.exp,
              "Log": torch.log, "Tanh": torch.tanh, "Sqrt": torch.sqrt,
              "Neg": torch.neg, "Abs": torch.abs, "Sign": torch.sign,
              "Floor": torch.floor, "Ceil": torch.ceil,
              "Reciprocal": torch.reciprocal, "Sigmoid": torch.sigmoid,
              "Erf": torch.erf, "Relu": torch.relu,
              "Identity": lambda v: v,
              "Greater": torch.gt, "Less": torch.lt,
              "GreaterOrEqual": torch.ge, "LessOrEqual": torch.le,
              "Equal": torch.eq, "Not": torch.logical_not,
              "And": torch.logical_and, "Or": torch.logical_or}
        if op in ew:
            return ew[op](*x)
        if op in ("Max", "Min"):
            fn = torch.maximum if op == "Max" else torch.minimum
            out = x[0]
            for v in x[1:]:
                out = fn(out, v)
            return out
        if op == "Where":
            return torch.where(x[0].bool(), x[1], x[2])
        if op == "Cast":
            dt = proto.ONNX2NP[int(a["to"])]
            return x[0].to(torch.from_numpy(onp.zeros((), dt)).dtype)
        if op == "Reshape":
            shape = [d if d != 0 else x[0].shape[i]
                     for i, d in enumerate(_ints(x[1]))]
            return x[0].reshape(shape)
        if op in ("Squeeze", "Unsqueeze"):
            axes = _ints(x[1]) if len(x) > 1 else list(a.get("axes", []))
            if op == "Unsqueeze":
                out = x[0]
                rank = out.dim() + len(axes)
                for ax in sorted(v % rank for v in axes):
                    out = out.unsqueeze(ax)
                return out
            if not axes:
                return x[0].squeeze()
            return x[0].squeeze(tuple(v % x[0].dim() for v in axes))
        if op == "Transpose":
            perm = a.get("perm") or list(reversed(range(x[0].dim())))
            return x[0].permute(*perm)
        if op == "Expand":
            shape = torch.broadcast_shapes(tuple(x[0].shape),
                                           tuple(_ints(x[1])))
            return x[0].expand(shape)
        if op == "Concat":
            return torch.cat(x, dim=int(a["axis"]))
        if op == "Slice":
            starts, ends = _ints(x[1]), _ints(x[2])
            axes = _ints(x[3]) if len(x) > 3 else list(range(len(starts)))
            steps = _ints(x[4]) if len(x) > 4 else [1] * len(starts)
            sl = [slice(None)] * x[0].dim()
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                if sp < 1:
                    raise _base.MXNetError("ONNX import: Slice with a "
                                           "step below 1")
                sl[ax] = slice(st, en, sp)
            return x[0][tuple(sl)]
        if op == "Pad":
            pads = _ints(x[1])
            n = x[0].dim()
            cval = float(x[2].reshape(-1)[0]) if len(x) > 2 else 0.0
            return Fn.pad(x[0], _spatial_pads(pads, n), value=cval)
        if op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceMean"):
            axes = _ints(x[1]) if len(x) > 1 else list(a.get("axes", []))
            keep = bool(a.get("keepdims", 1))
            dims = tuple(axes) if axes else tuple(range(x[0].dim()))
            if op == "ReduceSum":
                return x[0].sum(dim=dims, keepdim=keep)
            if op == "ReduceMean":
                return x[0].mean(dim=dims, keepdim=keep)
            fn = torch.amax if op == "ReduceMax" else torch.amin
            return fn(x[0], dim=dims, keepdim=keep)
        if op == "ArgMax":
            ax = int(a.get("axis", 0))
            return torch.argmax(x[0], dim=ax,
                                keepdim=bool(a.get("keepdims", 1)))
        if op == "Flatten":
            ax = int(a.get("axis", 1))
            return x[0].reshape(int(onp.prod(x[0].shape[:ax])), -1)
        if op == "MatMul":
            return torch.matmul(x[0], x[1])
        if op == "Gemm":
            y = torch.matmul(x[0].T if a.get("transA") else x[0],
                             x[1].T if a.get("transB") else x[1])
            y = y * a.get("alpha", 1.0)
            if len(x) > 2:
                y = y + x[2] * a.get("beta", 1.0)
            return y
        if op == "Einsum":
            return torch.einsum(a["equation"], *x)
        if op == "Conv":
            return self._conv(x, a)
        if op in ("MaxPool", "AveragePool"):
            return self._pool(op, x[0], a)
        if op == "GlobalAveragePool":
            return x[0].mean(dim=tuple(range(2, x[0].dim())), keepdim=True)
        if op == "BatchNormalization":
            xv, scale, b, mean, var = x[:5]
            eps = a.get("epsilon", 1e-5)
            shape = (1, -1) + (1,) * (xv.dim() - 2)
            return (xv - mean.reshape(shape)) / torch.sqrt(
                var.reshape(shape) + eps) * scale.reshape(shape) + \
                b.reshape(shape)
        if op == "Softmax":
            return torch.softmax(x[0], dim=int(a.get("axis", -1)))
        if op == "Constant":
            return torch.from_numpy(onp.array(a["value"])).to(self.device)
        if op == "Dropout":
            return x[0]
        raise _base.MXNetError(f"ONNX import: unsupported op {op!r}")

    def _conv(self, x, a):
        xv, w = x[0], x[1]
        n = xv.dim() - 2
        sym, pad = _symmetric(a.get("pads"), n)
        if not sym:
            xv = Fn.pad(xv, _spatial_pads(a.get("pads"), n))
            pad = [0] * n
        conv = (Fn.conv1d, Fn.conv2d, Fn.conv3d)[n - 1]
        return conv(xv, w, x[2] if len(x) > 2 else None,
                    stride=a.get("strides") or 1, padding=pad,
                    dilation=a.get("dilations") or 1,
                    groups=int(a.get("group", 1)))

    def _pool(self, op, xv, a):
        k = list(a["kernel_shape"])
        n = len(k)
        s = list(a.get("strides") or [1] * n)
        pads = _spatial_pads(a.get("pads"), n)
        if op == "MaxPool":
            fill = -float("inf") if xv.is_floating_point() else \
                torch.iinfo(xv.dtype).min
            xp = Fn.pad(xv, pads, value=fill)
            return (Fn.max_pool1d, Fn.max_pool2d, Fn.max_pool3d)[n - 1](
                xp, k, s)
        avg = (Fn.avg_pool1d, Fn.avg_pool2d, Fn.avg_pool3d)[n - 1]
        total = avg(Fn.pad(xv, pads), k, s) * float(onp.prod(k))
        if a.get("count_include_pad"):
            return total / float(onp.prod(k))
        ones = Fn.pad(torch.ones_like(xv), pads)
        return total / (avg(ones, k, s) * float(onp.prod(k)))


class ONNXBlock:
    """Callable imported model: NDArrays (or tensors, numpy arrays) in →
    NDArray(s) out, computed by torch ops on the block's device."""

    def __init__(self, model, ctx=None):
        self._device = resolve_device(ctx)
        self._ev = _Evaluator(model, self._device)
        self.input_names = [n for n, _, _ in self._ev.graph["inputs"]]

    def __call__(self, *args):
        feeds = {}
        for name, arg in zip(self.input_names, args):
            t = arg._t if isinstance(arg, NDArray) else torch.as_tensor(arg)
            feeds[name] = t.to(self._device)
        with torch.no_grad():
            outs = self._ev.run(feeds)
        res = [NDArray(o) for o in outs]
        return res[0] if len(res) == 1 else res


def import_model(path):
    """Load an ONNX file → (ONNXBlock, arg_params, aux_params): the
    callable on the current context (the card unless the caller asks for
    the CPU) plus the initializer dict, the reference's (sym,
    arg_params, aux_params) contract."""
    with open(path, "rb") as f:
        model = proto.parse_model(f.read())
    blk = ONNXBlock(model)
    args = {k: NDArray(v) for k, v in blk._ev.consts.items()}
    return blk, args, {}
