"""``mxnet_tpu_torch.analysis``: the runtime lock-order witness
(counterpart of ``mxnet_tpu/analysis/``).  Every lock-owning module of
the port constructs its locks through :func:`named_lock` /
:func:`named_rlock` / :func:`named_condition`; with the witness enabled
the process lock-ordering graph is built and its cycles and blocking
calls under held locks are reported.  The reference's AST linter and
static race guard (``lint.py``, ``raceguard.py``) are not ported yet
(ROADMAP queue A8)."""
from .lockwitness import (LockOrderError, LockWitness, active_witness,
                          disable, enable, known_lock_sites, named_condition,
                          named_lock, named_rlock, note_blocking)

__all__ = [
    "LockOrderError", "LockWitness", "active_witness", "disable",
    "enable", "known_lock_sites", "named_condition", "named_lock",
    "named_rlock", "note_blocking",
]
