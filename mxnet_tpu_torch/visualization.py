"""``mx.viz`` — network visualization (counterpart of
``mxnet_tpu/visualization.py``).

print_summary walks a Symbol and prints the layer table; plot_network
emits a graphviz Digraph when the optional graphviz package is
installed, and raises a typed error naming it otherwise.
"""
from __future__ import annotations

from . import base as _base

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120):
    """Print nodes of a Symbol DAG with op/name/inputs columns
    (parity: mx.viz.print_summary)."""
    nodes = []
    seen = set()

    def walk(s):
        if id(s) in seen:
            return
        seen.add(id(s))
        for i in s._inputs:
            walk(i)
        nodes.append(s)

    roots = symbol._inputs if symbol._op == "group" else [symbol]
    for r in roots:
        walk(r)
    hdr = f"{'Layer (type)':<40}{'Op':<24}{'Inputs':<40}"
    print("=" * line_length)
    print(hdr)
    print("=" * line_length)
    for n in nodes:
        ins = ", ".join(i._name for i in n._inputs)
        print(f"{n._name:<40}{n._op:<24}{ins:<40}")
    print("=" * line_length)
    print(f"Total nodes: {len(nodes)}")
    return nodes


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None):
    """Graphviz Digraph of a Symbol (parity: mx.viz.plot_network).
    Requires the optional ``graphviz`` package."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise _base.MXNetError(
            "plot_network needs the optional 'graphviz' package, which "
            "is not installed; use mx.viz.print_summary for a text "
            "rendering") from e
    dot = Digraph(name=title, format=save_format)
    seen = set()

    def walk(s):
        if id(s) in seen:
            return
        seen.add(id(s))
        shape_attr = ("oval" if s._op == "null" else "box")
        dot.node(str(id(s)), f"{s._name}\n{s._op}", shape=shape_attr)
        for i in s._inputs:
            walk(i)
            dot.edge(str(id(i)), str(id(s)))

    roots = symbol._inputs if symbol._op == "group" else [symbol]
    for r in roots:
        walk(r)
    return dot
