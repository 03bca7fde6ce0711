"""Runtime lock-order witness (counterpart of
``mxnet_tpu/analysis/lockwitness.py``, the same sites, findings and
allowlist).

The port's host locks (the serving engine's condition and step lock,
the batcher, the seeded generators, the metrics registry, the tracer,
the checkpoint integrity pool and the fault machinery itself) rest on a
partial order: as long as no two threads take two of them in opposite
orders, the process cannot deadlock.  This module checks that order on
the interleavings that actually run:

- Project locks are constructed through :func:`named_lock` /
  :func:`named_rlock` / :func:`named_condition` with a stable *site*
  name (``"serving.engine.cond"``).  **Disabled (the default), these
  return plain ``threading`` primitives**, so the witness costs nothing,
  like a :func:`~mxnet_tpu_torch.resilience.faults.inject` site with no
  plan active.
- Enabled (:func:`enable`, or ``MXTPU_LOCKWITNESS=1`` before import),
  locks come back wrapped: every acquisition pushes onto a per-thread
  held stack, and acquiring B while holding A adds the edge A→B to a
  process-wide lock-ordering graph.  A new edge that closes a cycle is
  a **potential deadlock witnessed on a real interleaving**, recorded
  as a typed finding (or raised as :class:`LockOrderError` with
  ``raise_on_cycle=True``).
- Known blocking points (a compiled program's launch, ``Future.result``
  waits, ``Condition.wait``) call :func:`note_blocking`; doing so while
  holding any witnessed lock is the *lock-held-across-blocking-call*
  finding: a scheduler that launches device work while holding the
  admission lock stalls every producer for the whole step.
- Two *different* locks from the same site nested (e.g. two engines'
  step locks) are a ``same_site`` finding: safe only under a consistent
  global order the graph cannot see, so it must be either fixed or
  allowlisted with a justification.

Findings can be allowlisted via ``lockwitness_allowlist.json`` next to
this module; each entry carries a mandatory justification.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..base import MXNetError

__all__ = ["LockOrderError", "LockWitness", "named_lock", "named_rlock",
           "named_condition", "note_blocking", "enable", "disable",
           "active_witness", "known_lock_sites", "KNOWN_LOCK_SITES",
           "DEFAULT_ALLOWLIST_PATH"]


class LockOrderError(MXNetError):
    """A witnessed lock-order cycle (potential deadlock) or a blocking
    call under a held lock, raised when the witness runs in strict
    mode (``enable(raise_on_cycle=True)``)."""


#: Every lock site ever constructed through this module (site → doc).
KNOWN_LOCK_SITES: Dict[str, str] = {}

#: The allowlist shipped with the package — findings with an in-tree
#: justification.
DEFAULT_ALLOWLIST_PATH = os.path.join(os.path.dirname(__file__),
                                      "lockwitness_allowlist.json")


def known_lock_sites() -> tuple:
    return tuple(sorted(KNOWN_LOCK_SITES))


# The one active witness.  Written under _WITNESS_LOCK; read lock-free
# on hot paths (single-reference torn reads are impossible in CPython).
_ACTIVE: Optional["LockWitness"] = None
_WITNESS_LOCK = threading.Lock()


class _Held:
    """One entry on a thread's held-lock stack."""
    __slots__ = ("site", "obj")

    def __init__(self, site: str, obj):
        self.site = site
        self.obj = obj


class LockWitness:
    """The process-wide ordering graph + finding recorder.

    Nodes are lock *sites* (not instances): every ``ReplicaHandle``
    lock is one node, which is what makes the graph small, stable
    across runs, and meaningful — an inversion between two *classes* of
    lock is the bug, whichever instances exhibited it first.
    """

    def __init__(self, raise_on_cycle: bool = False,
                 allowlist: Optional[List[dict]] = None):
        self.raise_on_cycle = bool(raise_on_cycle)
        self._lock = threading.Lock()      # internal; never witnessed
        self._tls = threading.local()
        # every thread's held stack, keyed by thread id — the fallback
        # for LEGAL cross-thread Lock releases (handoff patterns): the
        # releasing thread must be able to pop the owner's entry or it
        # goes stale and fabricates phantom ordering edges forever
        self._stacks: Dict[int, List[_Held]] = {}
        # site -> set of sites acquired while it was held
        self._graph: Dict[str, set] = {}
        self._seen_keys: set = set()       # finding dedup
        self.findings: List[dict] = []     # surviving findings
        self.allowed: List[dict] = []      # findings the allowlist ate
        self.acquisitions = 0
        self.per_site: Dict[str, int] = {}
        self._allowlist = [
            (e.get("kind"), tuple(sorted(e.get("sites", []))))
            for e in (allowlist or [])]

    # ------------------------------------------------------------- held TLS
    def _held(self) -> List[_Held]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
            with self._lock:
                self._stacks[threading.get_ident()] = h
        return h

    # ----------------------------------------------------------- recording
    def on_acquired(self, site: str, obj) -> None:
        held = self._held()
        # ALL held-stack access happens under the witness lock: the
        # cross-thread release path scans and mutates OTHER threads'
        # stacks, so even a thread's own stack is shared state
        with self._lock:
            new_edges: List[Tuple[str, str]] = []
            same_site_from = None
            for e in held:
                if e.obj is obj:
                    # reentrant re-acquire of the same RLock: not an edge
                    continue
                if e.site == site:
                    same_site_from = e
                else:
                    new_edges.append((e.site, site))
            held.append(_Held(site, obj))
            self.acquisitions += 1
            self.per_site[site] = self.per_site.get(site, 0) + 1
            if same_site_from is not None:
                self._record("same_site", (site,),
                             f"two distinct {site!r} locks nested in one "
                             f"thread — safe only under a consistent "
                             f"global order the witness cannot verify")
            for a, b in new_edges:
                succ = self._graph.setdefault(a, set())
                if b in succ:
                    continue
                cycle = self._path(b, a)
                succ.add(b)
                if cycle is not None:
                    path = [a] + cycle
                    self._record("cycle", tuple(sorted(set(path))),
                                 "lock-order cycle witnessed: "
                                 + " -> ".join(path))

    def on_released(self, site: str, obj) -> None:
        held = self._held()
        with self._lock:
            for i in range(len(held) - 1, -1, -1):
                if held[i].obj is obj:
                    del held[i]
                    return
            # not held by THIS thread: a cross-thread release
            # (threading.Lock explicitly allows it) — pop the owner's
            # entry so it cannot rot into phantom edges
            for stack in self._stacks.values():
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i].obj is obj:
                        del stack[i]
                        return

    def note_blocking(self, what: str, exclude=None) -> None:
        """A known blocking call is about to run on this thread; any
        witnessed lock still held (minus ``exclude`` — a Condition's
        own lock, which ``wait`` releases) is a finding."""
        held = self._held()
        with self._lock:
            sites = tuple(sorted({e.site for e in held
                                  if e.obj is not exclude}))
            if not sites:
                return
            self._record("blocking", sites + (what,),
                         f"blocking call {what!r} while holding "
                         f"{', '.join(sites)}", sites=list(sites) + [what])

    # caller holds self._lock
    def _record(self, kind: str, key: tuple, detail: str,
                sites: Optional[list] = None):
        dedup = (kind, key)
        if dedup in self._seen_keys:
            return
        self._seen_keys.add(dedup)
        finding = {"kind": kind,
                   "sites": sites if sites is not None else list(key),
                   "detail": detail,
                   "thread": threading.current_thread().name}
        if (kind, tuple(sorted(finding["sites"]))) in self._allowlist:
            self.allowed.append(finding)
            return
        self.findings.append(finding)
        if self.raise_on_cycle and kind == "cycle":
            raise LockOrderError(detail)

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS src→dst over the current graph; returns the site path
        (src..dst) or None.  Caller holds self._lock; the graph has
        tens of nodes, so recursion depth is a non-issue."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._graph.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -------------------------------------------------------------- report
    def cycles(self) -> List[dict]:
        with self._lock:
            return [f for f in self.findings if f["kind"] == "cycle"]

    def report(self) -> dict:
        """JSON-able summary: graph size, every edge, findings."""
        with self._lock:
            edges = sorted((a, b) for a, succ in self._graph.items()
                           for b in succ)
            return {
                "nodes": len({s for e in edges for s in e}
                             | set(self._graph)),
                "edges": len(edges),
                "edge_list": [f"{a} -> {b}" for a, b in edges],
                "acquisitions": self.acquisitions,
                "per_site": dict(sorted(self.per_site.items())),
                "findings": list(self.findings),
                "allowed": list(self.allowed),
                "cycles": len([f for f in self.findings
                               if f["kind"] == "cycle"]),
            }


# ------------------------------------------------------------ wrapped locks

class _WitnessedLock:
    """A ``threading.Lock``/``RLock`` wrapper that reports acquisitions
    to the active witness.  Created only while a witness is enabled;
    after ``disable()`` each op degrades to one global load + None
    check on top of the raw primitive."""

    __slots__ = ("site", "_raw")

    def __init__(self, site: str, raw):
        self.site = site
        self._raw = raw

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # the wrapper IS the lock implementation; callers still go
        # through `with`
        ok = self._raw.acquire(blocking, timeout)  # mxlint: disable=naked-acquire
        if ok:
            w = _ACTIVE
            if w is not None:
                try:
                    w.on_acquired(self.site, self)
                except LockOrderError:
                    # strict mode: the acquisition that completed the
                    # cycle raises — but the RAW lock is already held
                    # and __exit__ will never run, so undo both halves
                    # or the error leaves the lock leaked and a stale
                    # held-stack entry fabricating phantom edges
                    self._raw.release()
                    w.on_released(self.site, self)
                    raise
        return ok

    def release(self) -> None:
        self._raw.release()
        w = _ACTIVE
        if w is not None:
            w.on_released(self.site, self)

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self.acquire()  # mxlint: disable=naked-acquire
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<witnessed {self._raw!r} site={self.site!r}>"


class _WitnessedCondition(threading.Condition):
    """``threading.Condition`` over a witnessed lock; ``wait`` is a
    known blocking point (it releases ITS lock but anything else the
    thread holds blocks every peer for the whole wait)."""

    def __init__(self, site: str):
        self.site = site
        super().__init__(lock=_WitnessedLock(site, threading.Lock()))

    def wait(self, timeout: Optional[float] = None):
        w = _ACTIVE
        if w is not None:
            w.note_blocking(f"{self.site}.wait", exclude=self._lock)
        return super().wait(timeout)


def named_lock(site: str, doc: str = ""):
    """A project mutex with a stable site name.  Plain
    ``threading.Lock()`` unless a witness is enabled — the
    zero-cost-when-disabled contract (tested)."""
    KNOWN_LOCK_SITES.setdefault(site, doc)
    if _ACTIVE is None:
        return threading.Lock()
    return _WitnessedLock(site, threading.Lock())


def named_rlock(site: str, doc: str = ""):
    """Reentrant variant of :func:`named_lock` (re-acquiring the same
    instance is never an ordering edge)."""
    KNOWN_LOCK_SITES.setdefault(site, doc)
    if _ACTIVE is None:
        return threading.RLock()
    return _WitnessedLock(site, threading.RLock())


def named_condition(site: str, doc: str = ""):
    """Condition variable variant; its ``wait`` reports as a blocking
    point when other witnessed locks are held."""
    KNOWN_LOCK_SITES.setdefault(site, doc)
    if _ACTIVE is None:
        return threading.Condition()
    return _WitnessedCondition(site)


def note_blocking(what: str) -> None:
    """Hook placed before known blocking calls (engine dispatch,
    ``Future.result`` waits).  Zero-cost when disabled: one global load
    and a None check — keep this the ONLY code on that path."""
    w = _ACTIVE
    if w is not None:
        w.note_blocking(what)


# ------------------------------------------------------------- lifecycle

def load_allowlist(path: Optional[str] = None) -> List[dict]:
    """The in-repo justification file (see module docstring); absent
    file reads as empty."""
    path = path or DEFAULT_ALLOWLIST_PATH
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", data) if isinstance(data, dict) else data
    if not isinstance(entries, list):
        raise MXNetError(f"lockwitness allowlist {path!r} must hold a "
                         f"list of entries")
    return entries


def enable(raise_on_cycle: bool = False,
           allowlist_path: Optional[str] = None) -> LockWitness:
    """Install (or replace) the process-global witness and return it.
    Only locks constructed AFTER this call are witnessed — enable
    before building engines/routers (the env knob
    ``MXTPU_LOCKWITNESS=1`` does it at import, ahead of everything)."""
    global _ACTIVE
    w = LockWitness(raise_on_cycle=raise_on_cycle,
                    allowlist=load_allowlist(allowlist_path))
    with _WITNESS_LOCK:
        _ACTIVE = w
    return w


def disable() -> Optional[dict]:
    """Deactivate the witness; returns its final report (or None if it
    was not enabled).  Already-wrapped locks stay wrapped but pay only
    the global-load + None check per op afterwards."""
    global _ACTIVE
    with _WITNESS_LOCK:
        w, _ACTIVE = _ACTIVE, None
    return w.report() if w is not None else None


def active_witness() -> Optional[LockWitness]:
    return _ACTIVE


# Env-driven enable: MXTPU_LOCKWITNESS=1 turns the witness on before
# any project lock is constructed (this module is imported by every
# lock-owning module); MXTPU_LOCKWITNESS_OUT=path dumps the report at
# interpreter exit.
if os.environ.get("MXTPU_LOCKWITNESS", "") not in ("", "0"):
    enable(raise_on_cycle=os.environ.get("MXTPU_LOCKWITNESS_RAISE", "")
           not in ("", "0"))
    _out = os.environ.get("MXTPU_LOCKWITNESS_OUT", "")
    if _out:
        import atexit

        def _dump(path=_out):
            w = _ACTIVE
            if w is not None:
                with open(path, "w") as f:
                    json.dump(w.report(), f, indent=2, sort_keys=True)

        atexit.register(_dump)
