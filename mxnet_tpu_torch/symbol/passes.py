"""NNVM-style graph pass registry over the Symbol DAG (counterpart of
``mxnet_tpu/symbol/passes.py``).

Memory planning, placement and fusion are the runtime's; the passes
that survive are semantic graph rewrites.  Built-ins:

- ``"CommonSubexprElim"`` — merge structurally identical pure nodes
  (same op, attrs, inputs).  Stochastic and stateful ops (Dropout,
  sampling, BatchNorm's aux mutation) are never merged.
- ``"EliminateIdentity"`` — drop ``identity`` nodes (shape-preserving
  no-ops that appear in generated/imported graphs).

Custom passes register with :func:`register_pass` and run via
:func:`apply_pass` / ``Symbol.apply_pass(name)``.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from .. import base as _base
from . import Group, Symbol, _select, _topo

__all__ = ["register_pass", "apply_pass", "list_passes",
           "common_subexpr_elim", "eliminate_identity"]

_PASSES: Dict[str, Callable] = {}

# ops whose results must never be merged even when inputs coincide
# (Custom runs user host callbacks that may be stochastic or stateful)
_IMPURE_OPS = ("Dropout", "BatchNorm", "Custom")
# NOTE: bare "gamma" would wrongly catch the pure Gamma-function op;
# random gamma sampling is already covered by the sample_/random_ prefixes
_IMPURE_PREFIXES = ("sample_", "random_", "_random", "uniform", "normal",
                    "shuffle")


def register_pass(name: str):
    """Decorator: register ``fn(sym, **kwargs) -> Symbol`` under ``name``
    (parity: NNVM_REGISTER_PASS)."""
    def deco(fn):
        _PASSES[name] = fn
        return fn
    return deco


def list_passes() -> List[str]:
    return sorted(_PASSES)


def apply_pass(sym: Symbol, name: str, **kwargs) -> Symbol:
    if name not in _PASSES:
        raise _base.MXNetError(
            f"unknown graph pass {name!r}; registered: {list_passes()}")
    return _PASSES[name](sym, **kwargs)


def _same_inputs(a, b) -> bool:
    # Symbol.__eq__ is the ELEMENTWISE op — compare by object identity
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _is_impure(op: str) -> bool:
    return (op in _IMPURE_OPS
            or any(op.lower().startswith(p) for p in _IMPURE_PREFIXES))


def _rebuild(root: Symbol, node_map) -> Symbol:
    """Rewrite helper: ``node_map(old_base_node, new_inputs) -> Symbol``
    decides each base node's replacement; views/groups are re-wrapped."""
    memo: Dict[int, Symbol] = {}

    def visit(s: Symbol) -> Symbol:
        base = s._base or s
        if id(base) not in memo:
            new_inputs = [visit(i) for i in base._inputs]
            memo[id(base)] = node_map(base, new_inputs)
        nb = memo[id(base)]
        if s._out_index is not None:
            return _select(nb, s._out_index) if nb._num_outputs > 1 else nb
        return nb

    if root._op == "group":
        return Group([visit(o) for o in root._inputs])
    return visit(root)


@register_pass("CommonSubexprElim")
def common_subexpr_elim(sym: Symbol, **kwargs) -> Symbol:
    """Merge structurally identical pure nodes (op + attrs + inputs).

    Variables are shared by object identity already; two distinct
    Variables with the same name stay distinct (binding is by name, but
    merging them is not this pass's call)."""
    seen: Dict[tuple, Symbol] = {}

    def node_map(n: Symbol, new_inputs: List[Symbol]) -> Symbol:
        if n._op in ("null", "none") or _is_impure(n._op):
            if _same_inputs(n._inputs, new_inputs):
                return n
            return Symbol(n._op, n._name, new_inputs, n._attrs,
                          n._num_outputs)
        key = (
            n._op,
            tuple(sorted((k, repr(v)) for k, v in n._attrs.items()
                         if not k.startswith("__"))),
            tuple((id(i._base or i), i._out_index) for i in new_inputs),
        )
        hit = seen.get(key)
        if hit is not None:
            return hit
        out = (n if _same_inputs(n._inputs, new_inputs)
               else Symbol(n._op, n._name, new_inputs, n._attrs,
                           n._num_outputs))
        seen[key] = out
        return out

    return _rebuild(sym, node_map)


@register_pass("EliminateIdentity")
def eliminate_identity(sym: Symbol, **kwargs) -> Symbol:
    """Drop ``identity`` nodes, rewiring consumers to their input."""

    def node_map(n: Symbol, new_inputs: List[Symbol]) -> Symbol:
        if n._op == "identity" and len(new_inputs) == 1:
            return new_inputs[0]
        if _same_inputs(n._inputs, new_inputs):
            return n
        return Symbol(n._op, n._name, new_inputs, n._attrs, n._num_outputs)

    return _rebuild(sym, node_map)


def node_count(sym: Symbol) -> int:
    """Number of base nodes in the DAG (diagnostic for pass tests)."""
    return len(_topo(sym))
