"""``mx.name`` — symbol auto-naming scopes (counterpart of
``mxnet_tpu/name.py``): a thread-local stack of managers that
:mod:`.symbol` asks for each new node's name."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current() -> "NameManager":
    st = _stack()
    if not st:
        st.append(NameManager())
    return st[-1]


class NameManager:
    """Assigns ``{op}{n}`` names to anonymous symbols."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *a):
        _stack().pop()


class Prefix(NameManager):
    """``with mx.name.Prefix('stage1_'):`` — prepend to auto names."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
