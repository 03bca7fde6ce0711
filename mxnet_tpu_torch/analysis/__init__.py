"""``mxnet_tpu_torch.analysis`` — correctness tooling (counterpart of
``mxnet_tpu/analysis/``):

1. :mod:`~mxnet_tpu_torch.analysis.lockwitness` — the runtime
   lock-order witness.  Every lock-owning module of the port constructs
   its locks through :func:`named_lock` / :func:`named_rlock` /
   :func:`named_condition`; with the witness enabled the process
   lock-ordering graph is built and its cycles and blocking calls under
   held locks are reported.
2. :mod:`~mxnet_tpu_torch.analysis.lint` — the AST project linter
   behind ``tools/mxlint_torch.py``: fault sites registered, metrics and
   spans named and documented, serving/fleet raises MXNetError-typed,
   locks ``with``-scoped, the monotonic-clock convention.
3. :mod:`~mxnet_tpu_torch.analysis.raceguard` — static guarded-by race
   detection over the named-lock stack, plus the guard map
   (``concurrency_contract.json`` beside this file) that
   ``tools/chaos_sweep_torch.py --corroborate`` cross-checks against
   the witness's acquisition dump.

The lockwitness half is imported eagerly (every lock-owning module
needs the constructors at import); the linter and raceguard load
lazily — they pull in ``ast`` machinery no serving process wants.
"""
from .lockwitness import (LockOrderError, LockWitness, active_witness,
                          disable, enable, known_lock_sites, named_condition,
                          named_lock, named_rlock, note_blocking)

__all__ = [
    "LockOrderError", "LockWitness", "active_witness", "disable",
    "enable", "known_lock_sites", "named_condition", "named_lock",
    "named_rlock", "note_blocking",
    "run_lint", "Finding", "RULES",
    "build_guard_map", "corroborate", "raceguard",
]

_LAZY = {"run_lint": ".lint", "Finding": ".lint", "RULES": ".lint",
         "build_guard_map": ".raceguard", "corroborate": ".raceguard"}


def __getattr__(name):
    import importlib
    if name in ("raceguard", "lint"):      # lazy submodules
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    if name in _LAZY:
        obj = getattr(importlib.import_module(_LAZY[name], __name__), name)
        globals()[name] = obj
        return obj
    raise AttributeError(
        f"module 'mxnet_tpu_torch.analysis' has no attribute {name!r}")
