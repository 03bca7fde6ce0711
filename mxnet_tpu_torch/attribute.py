"""``mx.attribute`` — symbol attribute scopes (counterpart of
``mxnet_tpu/attribute.py``).  ``AttrScope`` attaches key/value attrs
(e.g. ``ctx_group``, ``__layout__``) to symbols created inside it; the
scopes are a thread-local stack that :mod:`.symbol` reads."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_attrs() -> dict:
    """The attrs of every open scope, inner scopes over outer ones."""
    out = {}
    for scope in _stack():
        out.update(scope._attrs)
    return out


class AttrScope:
    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    def get(self, attrs=None):
        out = current_attrs()
        if attrs:
            out.update(attrs)
        return out

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *a):
        _stack().pop()
