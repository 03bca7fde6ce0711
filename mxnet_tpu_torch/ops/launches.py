"""Kernel launch counters: one registry that every kernel wrapper joins.

A kernel wrapper adds one to its counters where it launches its kernel
and nowhere else, and registers them here when its module loads
(:func:`register`).  Whatever reads or moves the counts goes through
this registry: the serving programs, which record a capture's change and
add it at every replay (a replay runs no Python), and the card checks,
which zero and read them.  A counter is an attribute of its wrapper, an
int or a dict of ints by dtype, read afresh at each call, so a caller
that rebinds it is still seen.  A wrapper's first counter counts all of
its launches (:func:`totals`).
"""
from __future__ import annotations

__all__ = ["register", "wrappers", "snapshot", "add", "reset", "totals",
           "by_dtype"]

_REGISTRY = {}     # wrapper name -> (wrapper, its counters' attributes)


def register(fn, **counters):
    """Give the kernel wrapper ``fn`` its counters (attribute name →
    initial value: 0, or a dict of zeros by dtype) and register them;
    the first counts every launch.  Returns ``fn``."""
    for attr, val in counters.items():
        setattr(fn, attr, val)
    _REGISTRY[fn.__name__] = (fn, tuple(counters))
    return fn


def wrappers() -> dict:
    """{name: kernel wrapper} of every registered wrapper."""
    return {name: fn for name, (fn, _attrs) in _REGISTRY.items()}


def snapshot() -> dict:
    """Every counter, flattened: {(wrapper, attribute, dtype or None):
    n}."""
    out = {}
    for fn, attrs in _REGISTRY.values():
        for attr in attrs:
            val = getattr(fn, attr)
            if isinstance(val, dict):
                for dt, n in val.items():
                    out[(fn, attr, dt)] = n
            else:
                out[(fn, attr, None)] = val
    return out


def add(delta: dict):
    """Add a change of :func:`snapshot`'s form to the counters."""
    for (fn, attr, dt), n in delta.items():
        if not n:
            continue
        if dt is None:
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
            counts = getattr(fn, attr)
            counts[dt] = counts.get(dt, 0) + n


def reset():
    """Set every counter to 0."""
    for fn, attrs in _REGISTRY.values():
        for attr in attrs:
            val = getattr(fn, attr)
            setattr(fn, attr,
                    dict.fromkeys(val, 0) if isinstance(val, dict) else 0)


def totals() -> dict:
    """{wrapper name: launches}, from each wrapper's first counter."""
    out = {}
    for name, (fn, attrs) in _REGISTRY.items():
        val = getattr(fn, attrs[0])
        out[name] = sum(val.values()) if isinstance(val, dict) else val
    return out


def by_dtype() -> dict:
    """{wrapper name: {dtype name: launches}} for the wrappers that
    count by dtype."""
    out = {}
    for name, (fn, attrs) in _REGISTRY.items():
        val = getattr(fn, attrs[0])
        if isinstance(val, dict):
            out[name] = {str(dt).split(".")[-1]: n for dt, n in val.items()}
    return out
