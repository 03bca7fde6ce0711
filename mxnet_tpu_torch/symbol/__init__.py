"""``mx.sym`` — the symbolic graph API (counterpart of
``mxnet_tpu/symbol/__init__.py``).

A Symbol is a deferred-expression DAG over the same op registry that
backs ``mx.nd``: there is no separate symbolic kernel path.
``Executor.forward`` evaluates the DAG by replaying it through the nd
ops (recording torch's autograd graph when ``is_train``), so a symbol's
op on CUDA tensors runs the same code, kernels included, as the
imperative call.  Shape inference runs each node on fake tensors
(``torch._subclasses.FakeTensorMode``), as the reference runs it under
``jax.eval_shape``.

The JSON is the reference's NNVM-style graph JSON node for node (nodes
with op/name/attrs/inputs, ``op == "null"`` for variables,
arg_nodes/heads), so a graph saved by either package loads in the
other.
"""
from __future__ import annotations

import json as _json
from builtins import all as builtins_all
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _onp
import torch

from .. import base as _base
from ..context import Context, cpu, current_context
from ..ndarray import NDArray
from .. import ndarray as _nd_ops

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "Executor", "zeros", "ones", "arange"]


class Symbol:
    """A node in the deferred op DAG.

    ``op`` is an ``mx.nd`` op name (or ``"null"`` for a variable); ``inputs``
    are parent Symbols; ``attrs`` are the op's non-tensor kwargs.  A Symbol
    may be multi-output (``num_outputs > 1``, e.g. ``split``); ``out_index``
    selects one output of a multi-output parent.
    """

    def __init__(self, op: str, name: str, inputs: Sequence["Symbol"] = (),
                 attrs: Optional[Dict[str, Any]] = None, num_outputs: int = 1,
                 out_index: Optional[int] = None, base: "Symbol" = None):
        self._op = op
        self._name = name
        self._inputs = list(inputs)
        self._attrs = dict(attrs or {})
        self._num_outputs = num_outputs
        self._out_index = out_index
        self._base = base  # multi-output selection points at the base node

    # ------------------------------------------------------------- info
    @property
    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"<Symbol {self._name}>"

    def _walk_nulls(self):
        seen, order = set(), []

        def walk(s):
            s = s._base or s
            if id(s) in seen:
                return
            seen.add(id(s))
            for i in s._inputs:
                walk(i)
            if s._op == "null":
                order.append(s)

        walk(self)
        return order

    def _aux_info(self) -> Dict[str, str]:
        """{name: init hint} for null nodes consumed at AUX positions of
        layer ops — aux-ness derives from the op input position (like
        nnvm mutate_inputs), so user-supplied moving stats classify too."""
        info: Dict[str, str] = {}
        for n in _topo(self):
            spec = _PARAM_SPECS.get(n._op)
            if not spec:
                continue
            pnames, _, anames, ainits = spec
            for j, init in enumerate(ainits):
                pos = 1 + len(pnames) + j
                if pos < len(n._inputs):
                    node = n._inputs[pos]._base or n._inputs[pos]
                    if node._op == "null":
                        info[node._name] = init
        return info

    def list_arguments(self) -> List[str]:
        aux = self._aux_info()
        return [s._name for s in self._walk_nulls() if s._name not in aux]

    def list_auxiliary_states(self) -> List[str]:
        """Aux states (BatchNorm moving stats) — not gradient targets
        (parity: Symbol.list_auxiliary_states)."""
        aux = self._aux_info()
        return [s._name for s in self._walk_nulls() if s._name in aux]

    def default_aux_arrays(self, aux_shapes=None, **shapes) -> Dict[str,
                                                                    "NDArray"]:
        """Fresh aux-state arrays at their declared inits (moving_var =
        ones) — the single source both simple_bind and Module.bind use."""
        info = self._aux_info()
        names = self.list_auxiliary_states()
        if aux_shapes is None:
            _, _, aux_shapes = self.infer_shape(**shapes)
        return {n: (_nd_ops.ones(s) if info.get(n) == "ones"
                    else _nd_ops.zeros(s))
                for n, s in zip(names, aux_shapes)}

    def list_outputs(self) -> List[str]:
        if self._op == "group":
            return [o.list_outputs()[0] for o in self._inputs]
        if self._num_outputs > 1 and self._out_index is None:
            return [f"{self._name}_output{i}"
                    for i in range(self._num_outputs)]
        return [f"{self._name}_output"]

    @property
    def num_outputs(self) -> int:
        return len(self.list_outputs())

    def get_internals(self) -> "Symbol":
        nodes = _topo(self)
        outs = [n for n in nodes if n._op != "null"]
        return Group([_select(n, 0) if n._num_outputs > 1 else n
                      for n in outs]) if len(outs) > 1 else self

    def __getitem__(self, index):
        if isinstance(index, str):
            for n in _topo(self):
                if n._name == index or f"{n._name}_output" == index:
                    return n
            raise _base.MXNetError(f"no internal output {index!r}")
        if self._op == "group":
            return self._inputs[index]
        if self._num_outputs > 1 and self._out_index is None:
            return _select(self, index)
        if index == 0:
            return self
        raise IndexError(index)

    def __iter__(self):
        return iter([self[i] for i in range(self.num_outputs)])

    # -------------------------------------------------------- arithmetic
    def _binary(self, opname, other, reflected=False):
        if isinstance(other, Symbol):
            ins = (other, self) if reflected else (self, other)
            return _apply(opname, ins, {})
        attrs = {"scalar": float(other), "reflected": reflected}
        return _apply(f"_{opname}_scalar", (self,), attrs)

    def __add__(self, o): return self._binary("add", o)
    def __radd__(self, o): return self._binary("add", o, True)
    def __sub__(self, o): return self._binary("subtract", o)
    def __rsub__(self, o): return self._binary("subtract", o, True)
    def __mul__(self, o): return self._binary("multiply", o)
    def __rmul__(self, o): return self._binary("multiply", o, True)
    def __truediv__(self, o): return self._binary("divide", o)
    def __rtruediv__(self, o): return self._binary("divide", o, True)
    def __pow__(self, o): return self._binary("power", o)
    def __neg__(self): return _apply("negative", (self,), {})

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binary("equal", o)
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binary("not_equal", o)
        return NotImplemented

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------- evaluation
    def eval(self, ctx=None, **bindings) -> List[NDArray]:
        """Evaluate imperatively with NDArray bindings for each argument
        (other values become arrays on ``ctx``, default the current
        context)."""
        env = {k: v if isinstance(v, NDArray) else _nd_ops.array(v, ctx=ctx)
               for k, v in bindings.items()}
        with _scope(ctx):
            return _evaluate(self, env)

    def infer_shape(self, **shapes):
        """Returns (arg_shapes, out_shapes, aux_shapes) like MXNet.

        Partial inference (parity: nnvm InferShape): shapes given for the
        data arguments propagate forward, and the parameter variables of
        layer ops (FullyConnected/Convolution/BatchNorm/...) are SOLVED
        from their input shape + attrs — so auto-created weights need no
        explicit shape."""
        known = {k: tuple(v) for k, v in shapes.items()}
        node_shape = _infer_graph_shapes(self, known)
        args = self.list_arguments()
        aux = self.list_auxiliary_states()
        missing = [a for a in args + aux if known.get(a) is None]
        if missing:
            raise _base.MXNetError(f"infer_shape missing args {missing}")
        outs = []
        targets = self._inputs if self._op == "group" else [self]
        for t in targets:
            v = node_shape[id(t._base or t)]
            if t._out_index is not None and isinstance(v, list):
                v = v[t._out_index]
            outs.extend(v if isinstance(v, list) else [v])
        return ([known[a] for a in args], outs, [known[a] for a in aux])

    def infer_type(self, **dtypes):
        args = self.list_arguments()
        return ([_onp.dtype(dtypes.get(a, _onp.float32)) for a in args],
                [_onp.dtype(_onp.float32) for _ in self.list_outputs()], [])

    # ---------------------------------------------------------- binding
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None) -> "Executor":
        return Executor(self, ctx, args, args_grad, grad_req)

    def simple_bind(self, ctx=None, grad_req="write", **shapes) -> "Executor":
        """An Executor over zero arrays of the inferred shapes on ``ctx``
        (default: the current context), aux states at their inits."""
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        names = self.list_arguments()
        with _scope(ctx):
            args = {n: _nd_ops.zeros(s) for n, s in zip(names, arg_shapes)}
            args.update(self.default_aux_arrays(aux_shapes))
            grads = None
            if grad_req != "null":
                grads = {n: _nd_ops.zeros(s)
                         for n, s in zip(names, arg_shapes)}
        return Executor(self, ctx, args, grads, grad_req)

    # ---------------------------------------------------- serialization
    def optimize_for(self, backend, args=None, aux=None, **kwargs):
        """Apply a registered subgraph backend to this Symbol DAG
        (parity: Symbol.optimize_for → build_subgraph.cc; registry in
        mxnet_tpu.subgraph)."""
        from .. import subgraph as _subgraph
        return _subgraph.optimize_for(self, backend, **kwargs)

    def apply_pass(self, name, **kwargs):
        """Run a registered graph pass (parity: nnvm pass registry;
        see mxnet_tpu.symbol.passes)."""
        from . import passes as _passes
        return _passes.apply_pass(self, name, **kwargs)

    def tojson(self) -> str:
        nodes = _topo(self)
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": n._op if n._op != "null" else "null",
                "name": n._name,
                "attrs": {k: _json.dumps(v) if not isinstance(v, str) else v
                          for k, v in n._attrs.items()},
                "inputs": [[idx[id(i._base or i)], i._out_index or 0, 0]
                           for i in n._inputs],
            })
        heads = []
        if self._op == "group":
            for o in self._inputs:
                heads.append([idx[id(o._base or o)], o._out_index or 0, 0])
        else:
            base = self._base or self
            heads.append([idx[id(base)], self._out_index or 0, 0])
        return _json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n._op == "null"],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 20000]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # debug string roughly like MXNet's
    def debug_str(self):
        lines = []
        for n in _topo(self):
            ins = ", ".join(i._name for i in n._inputs)
            lines.append(f"{n._op}\t{n._name}({ins})")
        return "\n".join(lines)


# --------------------------------------------------------------- internals

_UID = [0]


def _auto_name(op):
    _UID[0] += 1
    return f"{op.lower()}{_UID[0]}"


def _select(base: Symbol, index: int) -> Symbol:
    s = Symbol(base._op, base._name, base._inputs, base._attrs,
               num_outputs=base._num_outputs, out_index=index, base=base)
    return s


def _scope_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ambient mx.attribute.AttrScope attrs under explicit ones."""
    from ..attribute import current_attrs
    ambient = current_attrs()
    if not ambient:
        return attrs
    out = dict(ambient)
    out.update(attrs or {})
    return out


def _apply(op: str, inputs: Sequence[Symbol], attrs: Dict[str, Any],
           name: Optional[str] = None, num_outputs: int = 1) -> Symbol:
    # an active mx.name scope (NameManager/Prefix) owns naming —
    # including prefixing EXPLICIT names, as upstream does
    from ..name import _stack as _name_stack
    if _name_stack():
        name = _name_stack()[-1].get(name, op.lower())
    elif name is None:
        name = _auto_name(op)
    return Symbol(op, name, inputs, _scope_attrs(attrs), num_outputs)


def _topo(root: Symbol) -> List[Symbol]:
    seen, order = set(), []

    def walk(s):
        s = s._base or s
        if id(s) in seen:
            return
        seen.add(id(s))
        for i in s._inputs:
            walk(i)
        if s._op != "group":
            order.append(s)

    walk(root)
    return order


def _run_node(n: Symbol, in_vals):
    """Execute one graph node through the nd op registry."""
    attrs = dict(n._attrs)
    if n._op.endswith("_scalar") and n._op.startswith("_"):
        opname = n._op[1:-len("_scalar")]
        scalar = attrs["scalar"]
        fn = getattr(_nd_ops, opname)
        if attrs.get("reflected"):
            return fn(scalar, in_vals[0])
        return fn(in_vals[0], scalar)
    fn = getattr(_nd_ops, n._op, None)
    if fn is None:
        raise _base.MXNetError(f"unknown op in graph: {n._op}")
    return fn(*in_vals, **attrs)


def _solve_param_shapes(op, data_shape, attrs):
    """Parameter-variable shapes of a layer op, solved from its input
    shape + attrs (position → shape, positions counted incl. data at 0)."""
    ds = tuple(data_shape)
    at = attrs
    if op == "FullyConnected":
        flatten = at.get("flatten", True)
        k = int(_onp.prod(ds[1:])) if flatten else ds[-1]
        nh = int(at["num_hidden"])
        return {1: (nh, k), 2: (nh,)}
    if op in ("Convolution", "Deconvolution"):
        kernel = tuple(at["kernel"])
        nf = int(at["num_filter"])
        g = int(at.get("num_group", 1))
        if op == "Convolution":
            w = (nf, ds[1] // g) + kernel
        else:
            w = (ds[1], nf // g) + kernel
        return {1: w, 2: (nf,)}
    if op == "Embedding":
        return {1: (int(at["input_dim"]), int(at["output_dim"]))}
    if op == "LayerNorm":
        c = ds[int(at.get("axis", -1))]
        return {1: (c,), 2: (c,)}
    if op == "BatchNorm":
        c = ds[int(at.get("axis", 1))]
        return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}
    if op == "SoftmaxOutput":
        return {1: ds[:-1]}      # label: data shape minus the class axis
    if op == "LinearRegressionOutput":
        return {1: ds}
    return {}


def _infer_graph_shapes(root: Symbol, known: Dict[str, tuple]):
    """Topo-walk shape inference: fills `known` for solvable variables and
    returns {node id: shape | [shapes]} for every node."""
    # Variable(shape=...) attrs participate
    for n in _topo(root):
        if n._op == "null" and "__shape__" in n._attrs:
            known.setdefault(n._name, tuple(n._attrs["__shape__"]))

    node_shape: Dict[int, Any] = {}

    def shp_of(i):
        v = node_shape.get(id(i._base or i))
        if i._out_index is not None and isinstance(v, list):
            v = v[i._out_index]
        return v

    for n in _topo(root):
        if n._op == "none":
            node_shape[id(n)] = None
            continue
        if n._op == "null":
            node_shape[id(n)] = known.get(n._name)
            continue
        if n._op == "group":
            continue
        in_shapes = [shp_of(i) for i in n._inputs]
        if n._op in _PARAM_SPECS and in_shapes and in_shapes[0] is not None:
            solved = _solve_param_shapes(
                n._op, in_shapes[0],
                {k: v for k, v in n._attrs.items()})
            for pos, shp in solved.items():
                if pos >= len(n._inputs):
                    continue
                node = n._inputs[pos]._base or n._inputs[pos]
                if node._op == "null" and node_shape.get(id(node)) is None:
                    node_shape[id(node)] = shp
                    known[node._name] = shp
                    in_shapes[pos] = shp
        unresolved = [i._name for i, s in zip(n._inputs, in_shapes)
                      if s is None and (i._base or i)._op == "null"]
        if unresolved:
            raise _base.MXNetError(
                f"infer_shape: cannot resolve {unresolved} feeding "
                f"{n._op} {n._name!r} — pass their shapes or use "
                "Variable(shape=...)")

        node_shape[id(n)] = _node_shapes(n, in_shapes)
    return node_shape


def _node_shapes(n: Symbol, in_shapes):
    """The output shape (or shapes) of node ``n`` on float32 inputs of
    ``in_shapes``, run on fake CPU tensors: shapes only, no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), cpu(), torch.no_grad():
        ins = [None if s is None else NDArray(torch.empty(s))
               for s in in_shapes]
        out = _run_node(n, ins)
    if isinstance(out, (list, tuple)):
        return [tuple(o.shape) for o in out]
    return tuple(out.shape)


def _scope(ctx):
    """``with ctx:`` for a given context (a Context, device or string),
    else no scope: arrays then go to the current context."""
    import contextlib
    if ctx is None:
        return contextlib.nullcontext()
    return ctx if isinstance(ctx, Context) else Context(torch.device(ctx))


def _evaluate(root: Symbol, env: Dict[str, NDArray],
              bn_capture: Optional[Dict[int, Any]] = None) -> List[NDArray]:
    """Run the DAG.  When ``bn_capture`` is given (training forward),
    BatchNorm nodes additionally report (aux arrays, batch stats) so the
    executor can update moving statistics — the aux-mutation the
    reference does INSIDE batch_norm.cc, kept outside the pure op here."""
    cache: Dict[int, Any] = {}
    for n in _topo(root):
        if n._op == "none":
            cache[id(n)] = None
            continue
        if n._op == "null":
            if n._name not in env:
                raise _base.MXNetError(f"unbound argument {n._name!r}")
            cache[id(n)] = env[n._name]
            continue
        ins = []
        for i in n._inputs:
            v = cache[id(i._base or i)]
            if i._out_index is not None:
                v = v[i._out_index]
            ins.append(v)
        if bn_capture is not None and n._op == "BatchNorm" \
                and not _attr_bool(n._attrs.get("use_global_stats")):
            momentum = float(n._attrs.get("momentum", 0.9))
            if _attr_bool(n._attrs.get("output_mean_var")):
                # batch stats are already among the node's outputs
                out = _run_node(n, ins)
                cache[id(n)] = out
                bn_capture[id(n)] = (ins[3], ins[4], out[1], out[2],
                                     momentum)
            else:
                attrs = dict(n._attrs)
                attrs["_internal_stats"] = True
                out, mean, var = _nd_ops.BatchNorm(*ins, **attrs)
                cache[id(n)] = out
                bn_capture[id(n)] = (ins[3], ins[4], mean, var, momentum)
        else:
            cache[id(n)] = _run_node(n, ins)

    def out_of(s):
        v = cache[id(s._base or s)]
        if s._out_index is not None:
            v = v[s._out_index]
        if isinstance(v, (list, tuple)):
            return list(v)
        return [v]

    if root._op == "group":
        outs = []
        for o in root._inputs:
            outs.extend(out_of(o))
        return outs
    return out_of(root)


# ----------------------------------------------------------------- factory

def Variable(name, shape=None, dtype=None, init=None, **kwargs) -> Symbol:
    s = Symbol("null", name, attrs=_scope_attrs({}))
    if shape is not None:
        s._attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        s._attrs["__dtype__"] = str(_onp.dtype(dtype))
    return s


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol("group", _auto_name("group"), list(symbols))


def load(fname) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def _attr_bool(v) -> bool:
    """Normalize a boolean op attr that may arrive as a Python bool or as
    an upstream-JSON string ('True'/'False'/'1'/'0' — MXNet 1.x serializes
    every attr as str, and 'False' is truthy)."""
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1")
    return bool(v)


def _op_num_outputs(opname: str, attrs) -> int:
    """Static output arity of an op node from its attrs — shared by the
    symbol factory and load_json so multi-output nodes survive the JSON
    roundtrip (a loaded node with the default arity of 1 would hand
    downstream consumers the whole output tuple)."""
    if opname in ("split", "SliceChannel"):
        return int(attrs.get("num_outputs",
                             attrs.get("indices_or_sections", 1)))
    if opname == "BatchNorm" and _attr_bool(attrs.get("output_mean_var")):
        return 3  # (out, batch_mean, batch_var)
    return 1


def load_json(json_str: str) -> Symbol:
    g = _json.loads(json_str)
    nodes: List[Symbol] = []
    for jn in g["nodes"]:
        attrs = {}
        for k, v in jn.get("attrs", {}).items():
            try:
                attrs[k] = _json.loads(v) if isinstance(v, str) else v
            except (ValueError, TypeError):
                attrs[k] = v
        if jn["op"] == "null":
            s = Symbol("null", jn["name"], attrs=attrs)
        else:
            ins = []
            for (nid, out_i, _) in jn["inputs"]:
                parent = nodes[nid]
                ins.append(_select(parent, out_i)
                           if parent._num_outputs > 1 else parent)
            s = Symbol(jn["op"], jn["name"], ins, attrs,
                       num_outputs=_op_num_outputs(jn["op"], attrs))
        nodes.append(s)
    heads = g["heads"]
    outs = []
    for (nid, out_i, _) in heads:
        parent = nodes[nid]
        outs.append(_select(parent, out_i)
                    if parent._num_outputs > 1 else parent)
    return outs[0] if len(outs) == 1 else Group(outs)


# ------------------------------------------------------------- executor

class Executor:
    """Graph executor (the reference's GraphExecutor via
    simple_bind/bind).

    ``forward`` replays the graph through the nd ops (recording torch's
    autograd graph when ``is_train``); ``backward`` pulls gradients into
    ``args_grad`` honoring ``grad_req``.  Arrays stay where they were
    bound; ops that make arrays from nothing (``zeros``, ``arange``) do
    so on ``ctx``, default the current context.
    """

    def __init__(self, symbol: Symbol, ctx, args, args_grad, grad_req):
        import os
        if os.environ.get("MXNET_TPU_GRAPH_CSE", "1") != "0":
            # bind-time common-subexpression elimination (the reference's
            # default; MXNET_TPU_GRAPH_CSE=0 disables).  Pure-node merge
            # only — see symbol/passes.py.
            from . import passes as _passes
            symbol = _passes.common_subexpr_elim(symbol)
        self._symbol = symbol
        self._ctx = ctx
        names = symbol.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(names, args_grad))
        self.arg_dict: Dict[str, NDArray] = dict(args or {})
        self.grad_dict: Dict[str, NDArray] = dict(args_grad or {})
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in names}
        self._grad_req = grad_req
        self.outputs: List[NDArray] = []
        self.aux_dict: Dict[str, NDArray] = {}

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n)
                for n in self._symbol.list_arguments()]

    def forward(self, is_train=False, **kwargs):
        from .. import autograd
        for k, v in kwargs.items():
            if not isinstance(v, NDArray):
                v = _nd_ops.array(v, ctx=self._ctx)
            self.arg_dict[k] = v
        with _scope(self._ctx):
            if is_train:
                self._forward_train(autograd)
            else:
                self.outputs = _evaluate(self._symbol, self.arg_dict)
        return self.outputs

    def _forward_train(self, autograd):
        self._tracked = []
        for n, a in self.arg_dict.items():
            req = self._grad_req.get(n, "null")
            if req != "null" and n in self.grad_dict:
                a.attach_grad(req)
                self._tracked.append(n)
        bn_capture: Dict[int, Any] = {}
        with autograd.record():
            self.outputs = _evaluate(self._symbol, self.arg_dict,
                                     bn_capture=bn_capture)
            self._train_outputs = self.outputs
        # moving-statistics update (batch_norm.cc's aux mutation), in
        # place; momentum was recorded at capture time
        with torch.no_grad():
            for _, (mm, mv, mean, var, m) in bn_capture.items():
                mm._t.copy_(m * mm._t + (1 - m) * mean._t)
                mv._t.copy_(m * mv._t + (1 - m) * var._t)

    def backward(self, out_grads=None):
        from .. import autograd
        outs = getattr(self, "_train_outputs", None)
        if outs is None:
            raise _base.MXNetError("backward before forward(is_train=True)")
        if out_grads is None:
            grads = [_nd_ops.ones_like(o) for o in outs]
        elif isinstance(out_grads, NDArray):
            grads = [out_grads]
        else:
            grads = list(out_grads)
        # heads no gradient reaches (an output of constants) add nothing
        pairs = [(o, g) for o, g in zip(outs, grads) if o._t.requires_grad]
        if pairs:
            autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        with torch.no_grad():
            for n in self._tracked:
                g = self.arg_dict[n].grad
                if g is not None:
                    self.grad_dict[n]._t.copy_(g._t)

    def copy_params_from(self, arg_params, aux_params=None):
        with torch.no_grad():
            for k, v in arg_params.items():
                if k in self.arg_dict:
                    self.arg_dict[k]._t.copy_(
                        v._t if isinstance(v, NDArray) else
                        torch.as_tensor(_onp.asarray(v)))


# ------------------------------------------------- symbolic op namespace

_SYM_ONLY = {"null", "group"}


# Layer ops whose parameter inputs auto-create named Variables when not
# given (parity: NNVM's ListArguments — sym.FullyConnected(data,
# num_hidden=k, name='fc1') materializes fc1_weight/fc1_bias).  Entries:
# (param names after data, init hints, aux names, aux init hints).
_PARAM_SPECS = {
    "FullyConnected": (("weight", "bias"), (None, "zeros"), (), ()),
    "Convolution": (("weight", "bias"), (None, "zeros"), (), ()),
    "Deconvolution": (("weight", "bias"), (None, "zeros"), (), ()),
    "Embedding": (("weight",), (None,), (), ()),
    "LayerNorm": (("gamma", "beta"), ("ones", "zeros"), (), ()),
    "BatchNorm": (("gamma", "beta"), ("ones", "zeros"),
                  ("moving_mean", "moving_var"), ("zeros", "ones")),
    # loss heads auto-create their label variable ({name}_label — the
    # classic "softmax_label" Module binds by label_names)
    "SoftmaxOutput": (("label",), (None,), (), ()),
    "LinearRegressionOutput": (("label",), (None,), (), ()),
}


def _kwargs_to_positional(opname, args, kwargs):
    """Move Symbol-valued keyword inputs (data=, weight=, label=, ...) into
    their positional slots per the nd op's signature — the dominant
    GluonCV-era calling idiom.  Unfilled intermediate slots become None."""
    if not any(isinstance(v, Symbol) for v in kwargs.values()):
        return args
    fn = getattr(_nd_ops, opname, None)
    if fn is None:
        return args
    import inspect
    try:
        sig = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return args
    merged = list(args)
    for idx in range(len(args), len(sig)):
        if not any(isinstance(v, Symbol) for v in kwargs.values()):
            break
        pn = sig[idx]
        if pn in kwargs and isinstance(kwargs[pn], Symbol):
            merged.append(kwargs.pop(pn))
        else:
            merged.append(None)
    return tuple(merged)


def _auto_params(opname, args, kwargs, name):
    """Fill missing/None param/aux inputs of a layer op with named
    Variables."""
    spec = _PARAM_SPECS.get(opname)
    if spec is None or not args or args[0] is None:
        return args
    pnames, pinits, anames, ainits = spec
    no_bias = bool(kwargs.get("no_bias", False))
    out = list(args)
    slots = list(zip(pnames, pinits)) + list(zip(anames, ainits))
    for slot_idx, (pname, init) in enumerate(slots):
        pos = 1 + slot_idx
        if pos < len(out) and out[pos] is not None:
            continue
        if pname == "bias" and no_bias:
            v = None
        else:
            v = Variable(f"{name}_{pname}")
            if init is not None:
                v._attrs["__init__"] = init
            # aux-vs-arg classification is positional (_aux_info), not
            # attr-driven — no marker is stored here
        if pos < len(out):
            out[pos] = v
        else:
            out.append(v)
    return tuple(out)


def _sym_op(opname):
    def op(*args, name: Optional[str] = None, **kwargs):
        args = _kwargs_to_positional(opname, args, kwargs)
        if opname in _PARAM_SPECS and name is None:
            # one prefix for the node AND its auto-created params, so
            # '{node}_weight' matches the node name (upstream convention)
            name = _auto_name(opname.lower())
        args = _auto_params(opname, args, kwargs, name)
        # None positional inputs (e.g. bias with no_bias=True) become "none"
        # sentinel nodes so argument positions survive serialization
        args = tuple(Symbol("none", _auto_name("none")) if a is None else a
                     for a in args)
        if not builtins_all(isinstance(a, Symbol) for a in args):
            raise _base.MXNetError(
                f"sym.{opname} expects Symbol inputs, got "
                f"{[type(a).__name__ for a in args]}")
        return _apply(opname, args, kwargs, name=name,
                      num_outputs=_op_num_outputs(opname, kwargs))

    op.__name__ = opname
    return op


class _SymContrib:
    """``mx.sym.contrib`` — upstream contrib ops resolve to the same
    symbolic op factory (parity: symbol/contrib generated namespace).
    Only REGISTERED ops (ops.__all__) resolve — module helpers/typing
    names must raise so hasattr feature-probes stay truthful."""

    def __getattr__(self, name):
        from ..ndarray import ops as _real_ops
        if not name.startswith("_") and name in _real_ops.__all__:
            return _sym_op(name)
        raise AttributeError(f"mx.sym.contrib has no op {name!r}")


contrib = _SymContrib()


def __getattr__(name):
    if name.startswith("_") or name in _SYM_ONLY:
        raise AttributeError(name)
    if hasattr(_nd_ops, name) and callable(getattr(_nd_ops, name)):
        fn = _sym_op(name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'mxnet_tpu_torch.symbol' has no attribute "
                         f"{name!r}")


def zeros(shape, dtype="float32", name=None, **kw):
    return _apply("zeros", (), {"shape": tuple(shape), "dtype": dtype},
                  name=name)


def ones(shape, dtype="float32", name=None, **kw):
    return _apply("ones", (), {"shape": tuple(shape), "dtype": dtype},
                  name=name)


def arange(start, stop=None, step=1.0, name=None, **kw):
    return _apply("arange", (), {"start": start, "stop": stop, "step": step},
                  name=name)
