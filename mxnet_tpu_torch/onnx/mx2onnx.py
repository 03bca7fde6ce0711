"""mx2onnx: export a Gluon block to ONNX (counterpart of
``mxnet_tpu/onnx/mx2onnx.py``).

The reference traces the block to a jaxpr and emits one group of ONNX
nodes per jax primitive.  Here the block's plain forward is traced by
the same ``torch.export`` as ``HybridBlock.export`` (inference mode,
parameters as inputs), decomposed to core ATen, and each ATen op is
emitted as the ONNX ops the reference emits for the same computation, so
both packages' importers read the file.  Parameters become initializers
named by their structural names (``.`` as ``_``); the inputs are
``data`` (or ``data0``, ``data1``, ...) with the shapes as written.  An
op outside the vocabulary raises a typed error naming it, as the
reference does for a primitive: among them the flash kernel's custom op
``mxnet_tpu_torch::flash_fwd``, which a transformer traced on the card
carries (ONNX has no such op, as it has no ``pallas_call``).
"""
from __future__ import annotations

import math
import operator
from typing import Dict, List

import numpy as onp
import torch

from .. import base as _base
from . import proto

__all__ = ["export_model"]

_aten = torch.ops.aten

# one ONNX op of the same inputs
_SIMPLE = {
    _aten.mul.Tensor: "Mul", _aten.div.Tensor: "Div",
    _aten.maximum.default: "Max", _aten.minimum.default: "Min",
    _aten.exp.default: "Exp", _aten.log.default: "Log",
    _aten.tanh.default: "Tanh", _aten.sigmoid.default: "Sigmoid",
    _aten.erf.default: "Erf", _aten.neg.default: "Neg",
    _aten.abs.default: "Abs", _aten.sqrt.default: "Sqrt",
    _aten.sign.default: "Sign", _aten.floor.default: "Floor",
    _aten.ceil.default: "Ceil", _aten.relu.default: "Relu",
    _aten.reciprocal.default: "Reciprocal",
    _aten.pow.Tensor_Tensor: "Pow", _aten.pow.Tensor_Scalar: "Pow",
    _aten.gt.Tensor: "Greater", _aten.gt.Scalar: "Greater",
    _aten.lt.Tensor: "Less", _aten.lt.Scalar: "Less",
    _aten.ge.Tensor: "GreaterOrEqual", _aten.ge.Scalar: "GreaterOrEqual",
    _aten.le.Tensor: "LessOrEqual", _aten.le.Scalar: "LessOrEqual",
    _aten.eq.Tensor: "Equal", _aten.eq.Scalar: "Equal",
    _aten.logical_not.default: "Not", _aten.logical_and.default: "And",
    _aten.logical_or.default: "Or", _aten.mul.Scalar: "Mul",
    _aten.div.Scalar: "Div",
}
_IDENTITY = (_aten.clone.default, _aten.alias.default,
             _aten.detach.default, _aten.lift_fresh_copy.default)
_REDUCE = {_aten.sum.dim_IntList: "ReduceSum", _aten.mean.dim: "ReduceMean",
           _aten.amax.default: "ReduceMax", _aten.amin.default: "ReduceMin"}
_FACTORIES = (_aten.full.default, _aten.scalar_tensor.default,
              _aten.arange.start_step, _aten.arange.default,
              _aten.zeros.default, _aten.ones.default)


def _np_dtype(dt: torch.dtype):
    return torch.empty((), dtype=dt).numpy().dtype


def _op_name(target) -> str:
    schema = getattr(target, "_schema", None)
    return schema.name if schema is not None else str(target)


class _Converter:
    def __init__(self):
        self.nodes: List = []
        self.initializers: List = []
        self.names: Dict[str, str] = {}   # fx node name -> onnx name
        self.counter = 0

    # ------------------------------------------------------------ helpers
    def fresh(self, hint="t"):
        self.counter += 1
        return f"{hint}_{self.counter}"

    def const(self, arr, hint="const"):
        name = self.fresh(hint)
        self.initializers.append(proto.tensor(name, onp.asarray(arr)))
        return name

    def ints(self, vals, hint="const"):
        return self.const(onp.asarray(list(vals), onp.int64), hint)

    def emit(self, op, ins, n_out=1, **attrs):
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(proto.node(op, ins, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def name_of(self, a, like=None):
        """ONNX name of an fx argument: a node, or a Python number made
        a constant of ``like``'s dtype (float32 without one)."""
        if isinstance(a, torch.fx.Node):
            return self.names[a.name]
        dt = _np_dtype(like.meta["val"].dtype) if like is not None \
            else onp.float32
        return self.const(onp.asarray(a, dt), "lit")

    # -------------------------------------------------------------- nodes
    def convert(self, node):
        t, args = node.target, node.args
        if t is operator.getitem:
            src, i = args
            vals = self.names[src.name]
            if not isinstance(vals, list) or vals[i] is None:
                raise _base.MXNetError(
                    f"ONNX export: output {i} of {src.target} is not "
                    "exportable")
            self.names[node.name] = vals[i]
            return
        self.names[node.name] = self.op(node, t, args, node.kwargs)

    def op(self, node, t, args, kw):
        x0 = args[0] if args else None
        like = x0 if isinstance(x0, torch.fx.Node) else None
        if t in _SIMPLE:
            return self.emit(_SIMPLE[t], [self.name_of(a, like)
                                          for a in args[:2]])
        if t in (_aten.add.Tensor, _aten.sub.Tensor, _aten.add.Scalar,
                 _aten.sub.Scalar):
            b = args[1]
            alpha = kw.get("alpha", 1)
            y = self.name_of(b, like)
            if alpha != 1:
                y = self.emit("Mul", [y, self.name_of(alpha, like)])
            op = "Add" if t in (_aten.add.Tensor, _aten.add.Scalar) \
                else "Sub"
            return self.emit(op, [self.name_of(x0), y])
        if t is _aten.rsub.Scalar:
            return self.emit("Sub", [self.name_of(args[1], like),
                                     self.name_of(x0)])
        if t is _aten.rsqrt.default:
            return self.emit("Reciprocal",
                             [self.emit("Sqrt", [self.name_of(x0)])])
        if t in _IDENTITY:
            return self.emit("Identity", [self.name_of(x0)])
        if t in (_aten._to_copy.default, _aten.to.dtype):
            dt = kw.get("dtype", args[1] if len(args) > 1 else None)
            if dt is None:
                return self.emit("Identity", [self.name_of(x0)])
            return self.emit("Cast", [self.name_of(x0)],
                             to=proto.NP2ONNX[_np_dtype(dt)])
        if t is _aten.where.self:
            return self.emit("Where", [self.name_of(a, args[1])
                                       for a in args])
        if t in (_aten.view.default, _aten._unsafe_view.default,
                 _aten.reshape.default):
            shape = list(node.meta["val"].shape)
            return self.emit("Reshape", [self.name_of(x0),
                                         self.ints(shape)])
        if t is _aten.permute.default:
            return self.emit("Transpose", [self.name_of(x0)],
                             perm=[int(d) for d in args[1]])
        if t is _aten.t.default:
            return self.emit("Transpose", [self.name_of(x0)], perm=[1, 0])
        if t is _aten.expand.default:
            return self.emit("Expand", [self.name_of(x0), self.ints(
                node.meta["val"].shape)])
        if t is _aten.unsqueeze.default:
            return self.emit("Unsqueeze", [self.name_of(x0),
                                           self.ints([args[1]])])
        if t in (_aten.squeeze.dims, _aten.squeeze.dim):
            dims = args[1] if isinstance(args[1], (list, tuple)) \
                else [args[1]]
            rank = len(x0.meta["val"].shape)
            dims = [d % rank for d in dims
                    if x0.meta["val"].shape[d % rank] == 1]
            if not dims:
                return self.emit("Identity", [self.name_of(x0)])
            return self.emit("Squeeze", [self.name_of(x0),
                                         self.ints(dims)])
        if t is _aten.cat.default:
            axis = args[1] if len(args) > 1 else kw.get("dim", 0)
            return self.emit("Concat", [self.name_of(a) for a in x0],
                             axis=int(axis))
        if t is _aten.slice.Tensor:
            dim = args[1] if len(args) > 1 else 0
            start = args[2] if len(args) > 2 and args[2] is not None else 0
            end = args[3] if len(args) > 3 and args[3] is not None \
                else 2 ** 62
            step = args[4] if len(args) > 4 else 1
            size = x0.meta["val"].shape[dim]
            end = min(end, size)
            return self.emit("Slice", [
                self.name_of(x0), self.ints([start]), self.ints([end]),
                self.ints([dim]), self.ints([step])])
        if t is _aten.select.int:
            dim, i = args[1], args[2]
            s = self.emit("Slice", [self.name_of(x0), self.ints([i]),
                                    self.ints([i + 1 if i != -1 else
                                               2 ** 62]),
                                    self.ints([dim]), self.ints([1])])
            return self.emit("Squeeze", [s, self.ints([dim])])
        if t in (_aten.mm.default, _aten.bmm.default,
                 _aten.matmul.default):
            return self.emit("MatMul", [self.name_of(a) for a in args[:2]])
        if t is _aten.addmm.default:
            bias, a, b = args[:3]
            y = self.emit("MatMul", [self.name_of(a), self.name_of(b)])
            if kw.get("alpha", 1) != 1:
                y = self.emit("Mul", [y, self.name_of(kw["alpha"], a)])
            c = self.name_of(bias)
            if kw.get("beta", 1) != 1:
                c = self.emit("Mul", [c, self.name_of(kw["beta"], a)])
            return self.emit("Add", [y, c])
        if t in _REDUCE:
            dims = args[1] if len(args) > 1 else kw.get("dim")
            keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
            rank = len(x0.meta["val"].shape)
            dims = list(range(rank)) if not dims else \
                [d % rank for d in dims]
            return self.emit(_REDUCE[t], [self.name_of(x0),
                                          self.ints(dims)],
                             keepdims=int(bool(keep)))
        if t is _aten.argmax.default:
            dim = args[1] if len(args) > 1 else kw.get("dim")
            keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
            if dim is None:
                raise _base.MXNetError("ONNX export: argmax over all axes")
            return self.emit("ArgMax", [self.name_of(x0)], axis=int(dim),
                             keepdims=int(bool(keep)))
        if t in (_aten._softmax.default, _aten._log_softmax.default):
            y = self.emit("Softmax", [self.name_of(x0)], axis=int(args[1]))
            return y if t is _aten._softmax.default else \
                self.emit("Log", [y])
        if t is _aten.gelu.default:
            return self._gelu(node, x0, kw.get("approximate", "none"))
        if t is _aten.hardtanh.default or t is _aten.clamp.default:
            lo, hi = (list(args[1:]) + [None, None])[:2] \
                if t is _aten.clamp.default else \
                ((list(args[1:]) + [-1.0, 1.0])[:2])
            y = self.name_of(x0)
            if lo is not None:
                y = self.emit("Max", [y, self.name_of(lo, x0)])
            if hi is not None:
                y = self.emit("Min", [y, self.name_of(hi, x0)])
            return y
        if t is _aten.leaky_relu.default:
            slope = args[1] if len(args) > 1 else 0.01
            x = self.name_of(x0)
            pos = self.emit("Greater", [x, self.name_of(0.0, x0)])
            neg = self.emit("Mul", [x, self.name_of(slope, x0)])
            return self.emit("Where", [pos, x, neg])
        if t is _aten.convolution.default:
            return self._conv(node, args)
        if t is _aten.max_pool2d_with_indices.default:
            return [self._pool(node, args, "MaxPool"), None]
        if t is _aten.avg_pool2d.default:
            return self._pool(node, args, "AveragePool")
        if t is _aten._adaptive_avg_pool2d.default:
            if tuple(args[1]) != (1, 1):
                raise _base.MXNetError(
                    f"ONNX export: adaptive average pool to {args[1]}")
            return self.emit("GlobalAveragePool", [self.name_of(x0)])
        if t is _aten._native_batch_norm_legit_no_training.default:
            x, w, b, mean, var, _momentum, eps = args
            y = self.emit("BatchNormalization", [
                self.name_of(x), self.name_of(w), self.name_of(b),
                self.name_of(mean), self.name_of(var)], epsilon=float(eps))
            return [y, None, None]
        if t is _aten.native_layer_norm.default:
            return [self._layer_norm(args), None, None]
        if t in _FACTORIES:
            return self.const(_constant_value(node), "c")
        raise _base.MXNetError(
            f"ONNX export: unsupported op {_op_name(t)!r}")

    # --------------------------------------------------------- compound
    def _gelu(self, node, x0, approximate):
        x = self.name_of(x0)
        half = self.emit("Mul", [x, self.name_of(0.5, x0)])
        if approximate == "tanh":
            cube = self.emit("Mul", [self.emit("Mul", [x, x]), x])
            inner = self.emit("Add", [x, self.emit(
                "Mul", [cube, self.name_of(0.044715, x0)])])
            th = self.emit("Tanh", [self.emit("Mul", [inner, self.name_of(
                math.sqrt(2.0 / math.pi), x0)])])
            return self.emit("Mul", [half, self.emit(
                "Add", [th, self.name_of(1.0, x0)])])
        e = self.emit("Erf", [self.emit("Mul", [x, self.name_of(
            1.0 / math.sqrt(2.0), x0)])])
        return self.emit("Mul", [half, self.emit(
            "Add", [e, self.name_of(1.0, x0)])])

    def _layer_norm(self, args):
        x, shape, w, b, eps = args
        rank = len(x.meta["val"].shape)
        axes = self.ints(range(rank - len(shape), rank))
        xn = self.name_of(x)
        mean = self.emit("ReduceMean", [xn, axes], keepdims=1)
        d = self.emit("Sub", [xn, mean])
        var = self.emit("ReduceMean", [self.emit("Mul", [d, d]), axes],
                        keepdims=1)
        y = self.emit("Div", [d, self.emit("Sqrt", [self.emit(
            "Add", [var, self.name_of(float(eps), x)])])])
        if w is not None:
            y = self.emit("Mul", [y, self.name_of(w)])
        if b is not None:
            y = self.emit("Add", [y, self.name_of(b)])
        return y

    def _conv(self, node, args):
        x, w, b, stride, padding, dilation, transposed, _opad, groups = args
        if transposed:
            raise _base.MXNetError("ONNX export: transposed convolution "
                                   "is not exportable")
        ins = [self.name_of(x), self.name_of(w)]
        if b is not None:
            ins.append(self.name_of(b))
        nd = len(w.meta["val"].shape) - 2
        pad = list(padding) if len(padding) == nd else [padding[0]] * nd
        return self.emit(
            "Conv", ins, kernel_shape=list(w.meta["val"].shape[2:]),
            strides=[int(s) for s in _n(stride, nd)],
            dilations=[int(d) for d in _n(dilation, nd)],
            pads=[int(p) for p in pad + pad], group=int(groups))

    def _pool(self, node, args, opn):
        x = args[0]
        kernel = [int(k) for k in _n(args[1], 2)]
        stride = [int(s) for s in _n(args[2] if len(args) > 2 and args[2]
                                     else kernel, 2)]
        pad = [int(p) for p in _n(args[3] if len(args) > 3 else 0, 2)]
        if opn == "MaxPool":
            dil = _n(args[4] if len(args) > 4 else 1, 2)
            ceil = args[5] if len(args) > 5 else False
            if any(d != 1 for d in dil):
                raise _base.MXNetError("ONNX export: dilated max pool")
        else:
            ceil = args[4] if len(args) > 4 else False
            if len(args) > 6 and args[6] is not None:
                raise _base.MXNetError("ONNX export: avg_pool2d "
                                       "divisor_override")
        if ceil:
            raise _base.MXNetError("ONNX export: ceil-mode pooling")
        kw = dict(kernel_shape=kernel, strides=stride, pads=pad + pad)
        if opn == "AveragePool":
            kw["count_include_pad"] = int(
                args[5] if len(args) > 5 else True)
        return self.emit(opn, [self.name_of(x)], **kw)


def _n(v, n):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return v * n if len(v) == 1 else v


def _constant_value(node):
    """A factory node's value, computed on the CPU from its arguments."""
    kw = {k: v for k, v in node.kwargs.items()
          if k not in ("device", "pin_memory", "layout")}
    out = node.target(*node.args, device="cpu", **kw)
    return out.numpy()


def export_model(net, path, input_shapes, input_dtype="float32",
                 opset=13):
    """Export an initialized Gluon block to ``path`` (ONNX file).

    input_shapes: one shape tuple (single input) or a list of them.
    Returns the path.  Inference semantics (BatchNorm uses its running
    statistics, dropout is the identity), as the reference exports
    inference graphs.  The inputs are zeros on the block's device."""
    from ..context import resolve_device
    from ..gluon import block as _block

    if opset < 13:
        raise _base.MXNetError(
            "export emits opset-13 node forms (Squeeze/ReduceSum axes as "
            f"inputs, GreaterOrEqual, ...); opset={opset} < 13 would "
            "declare a version the nodes violate")
    if isinstance(input_shapes, tuple):
        input_shapes = [input_shapes]
    dt = onp.dtype(input_dtype)
    dev = net.device if net.device is not None else resolve_device(None)
    xs = [torch.zeros(tuple(s), dtype=torch.from_numpy(
        onp.zeros((), dt)).dtype, device=dev) for s in input_shapes]
    # settle deferred shapes
    with _base.training_mode(False), torch.no_grad():
        prev = _base.set_recording(False)
        try:
            net(*xs)
        finally:
            _base.set_recording(prev)
    named = dict(net.named_parameters())
    order = list(named)
    params = [named[n].detach() for n in order]
    _flat, spec, _static = _block._flatten_in_args(xs)
    ep = _block._trace(_block._Exported(net, order, spec), params, xs,
                       dynamic=False).run_decompositions()

    # an op of another namespace than aten (the flash kernel's) is never
    # exportable: name it before converting what precedes it
    custom = sorted({_op_name(n.target) for n in ep.graph.nodes
                     if isinstance(n.target, torch._ops.OpOverload)
                     and n.target.namespace != "aten"})
    if custom:
        raise _base.MXNetError(
            f"ONNX export: unsupported op{'s' if len(custom) > 1 else ''} "
            f"{', '.join(repr(o) for o in custom)}")
    cv = _Converter()
    sig = ep.graph_signature
    consts = sig.inputs_to_lifted_tensor_constants
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    user = [n for n in placeholders if n.name not in consts]
    graph_inputs = []
    for n in placeholders:
        if n.name in consts:
            cv.names[n.name] = cv.const(
                ep.constants[consts[n.name]].detach().cpu().numpy(), "c")
    for i, n in enumerate(user):
        if i < len(params):
            nm = order[i].replace(".", "_")
            cv.initializers.append(proto.tensor(
                nm, params[i].float().cpu().numpy()
                if params[i].dtype == torch.bfloat16
                else params[i].cpu().numpy()))
        else:
            j = i - len(params)
            nm = "data" if len(xs) == 1 else f"data{j}"
            graph_inputs.append(proto.value_info(nm, dt, xs[j].shape))
        cv.names[n.name] = nm
    outputs = []
    for node in ep.graph.nodes:
        if node.op == "call_function":
            cv.convert(node)
        elif node.op == "output":
            for o in node.args[0]:
                val = o.meta["val"]
                nm = cv.names[o.name]
                outputs.append(proto.value_info(
                    nm, _np_dtype(val.dtype), tuple(val.shape)))
    g = proto.graph(cv.nodes, "mxnet_tpu_torch_export", cv.initializers,
                    graph_inputs, outputs)
    with open(path, "wb") as f:
        f.write(proto.model(g, opset=opset))
    return path
