"""raceguard — static guarded-by race detection for the named-lock
stack, cross-checked against the runtime lock witness.

The linter and the lock witness make lock *ordering* mechanical, but
neither checks *which shared state each lock actually guards*: an
attribute read outside its lock compiles, passes tier-1, and corrupts
stats or scheduling only under real concurrency.  That property is
statically decidable for exactly the disciplined, ``with``-scoped
locking style mxlint already mandates — the same observation behind
classic lockset analysis (Eraser) and annotation checking (Clang
``-Wthread-safety`` / ``GuardedBy``), cited here as prior art by name.

The pass is purely static (:mod:`ast`, never imports the code under
analysis) and runs per class:

1. **Guard binding** — every ``self._x = named_lock/named_rlock/
   named_condition("site")`` (anywhere in the assigned expression, so
   ``self._cond = cond or _named_condition(...)`` binds too) makes
   ``_x`` a *guard* with a stable lock site.
2. **Guarded-set inference** — any ``self.attr`` *written* (attribute
   store, augmented store, or a subscript/del store whose base is the
   attribute) while a guard is lexically held, in a non-``__init__``
   method, marks ``attr`` guarded by the guards held at locked writes.
   An attribute written under several guards at different sites is
   satisfied by any one of them (pin it down with an explicit
   declaration if that is too permissive).
3. **Access checking** — every read or write of a guarded attribute
   reached while none of its guards is held is a ``guarded-by``
   finding.  ``__init__`` is exempt end to end: pre-publication state
   is thread-private by construction.
4. **Declarations** — ``# guarded-by: _lock`` widens inference:

   - on a ``self.attr = ...`` line it declares the attribute guarded
     (even if no locked write exists for the inference to see);
   - on a ``def`` line it declares a caller-holds-lock contract: the
     whole method body is analyzed as if ``_lock`` were held (the
     static mirror of a "caller holds self._lock" comment).

   A declaration naming a non-guard, or floating on a line that is
   neither of the above, is a ``guard-declare`` finding.
5. **Escape hatch** — ``# raceguard: unguarded(<justification>)`` on
   the offending line suppresses its ``guarded-by`` findings, and
   ``# raceguard: callback-ok(<justification>)`` its
   ``callback-under-lock`` findings.  Justifications are VALIDATED
   (>= 20 chars) — a bare pragma is itself a ``guard-declare``
   finding, exactly like the lockwitness allowlist's mandatory
   justification.
6. **callback-under-lock** — resolving a future (``set_result`` /
   ``set_exception`` / ``add_done_callback``) or invoking a
   user-supplied callback (``callback``/``cb``/``*_callback``) while
   a guard is held runs arbitrary foreign code — waiter wake-ups and
   re-entrant calls — inside the critical section: the static
   analogue of the witness's ``blocking`` finding.

Known approximations (the runtime witness covers the dynamics):
the analysis is lexical, so a ``Condition.wait`` (which releases its
lock mid-block) still counts as held; accesses to *other* objects'
guarded attributes are out of scope (only ``self.`` accesses are
checked); nested ``def``/``lambda`` bodies reset the held set — a
closure created under a lock usually runs after it is released — and
can re-enter via their own ``guarded-by:`` declaration.

The static↔dynamic loop closes through the **guard map**
(:func:`build_guard_map`): lock site → guarded attributes for every
``named_*`` construction in the tree, class- or module-scoped.  It is
checked in as ``mxnet_tpu_torch/analysis/concurrency_contract.json``
(drift-tested), and ``tools/chaos_sweep_torch.py --corroborate`` diffs
it against the witness's acquisition dump so every statically-claimed
guard is proven exercised and every witnessed site statically mapped.

Counterpart of ``mxnet_tpu/analysis/raceguard.py``: the same rules,
pragmas and map schema; only :data:`CORROBORATION_EXEMPT` (the port's
own cold sites, decided per device by :func:`corroboration_exempt`)
and ``generated_by`` differ.
"""
from __future__ import annotations

import ast
import collections
import os
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

__all__ = ["RACEGUARD_RULES", "GuardBinding", "ModuleGuards",
           "analyze_module", "build_guard_map", "CALLBACK_METHODS",
           "CORROBORATION_EXEMPT", "GUARD_MAP_SCHEMA_VERSION",
           "corroboration_exempt"]

RACEGUARD_RULES: Dict[str, str] = {
    "guarded-by": "guarded attribute accessed outside its lock",
    "guard-declare": "malformed guarded-by declaration or raceguard "
                     "pragma (unknown guard, orphan line, missing or "
                     "short justification)",
    "callback-under-lock": "future resolution / user callback invoked "
                           "while a guard is held",
}

#: constructors that make an attribute a guard (site = first str arg)
GUARD_CTORS: Dict[str, str] = {
    "named_lock": "lock", "_named_lock": "lock",
    "named_rlock": "rlock", "_named_rlock": "rlock",
    "named_condition": "condition", "_named_condition": "condition",
}

#: method names that resolve a future — foreign code (waiter wake-ups,
#: done-callbacks) runs inside them
CALLBACK_METHODS = ("set_result", "set_exception", "add_done_callback")
#: callable names treated as user-supplied callbacks
_CALLBACK_NAMES = ("callback", "cb")
_CALLBACK_SUFFIX = "_callback"

#: guard-map sites a chaos sweep on the CPU cannot legitimately
#: exercise, with the mandatory justification (>= 20 chars, tested) —
#: the corroboration analogue of the lockwitness allowlist
CORROBORATION_EXEMPT: Dict[str, str] = {
    "native.build": "acquired only while building a native library: the "
                    "CUDA kernels (never on a CPU host, which has no nvcc) "
                    "or the optional JPEG reader, which no sweep scenario "
                    "reads; on a CUDA device the sweep builds the kernels, "
                    "so the site is exempt on the CPU only",
}

def corroboration_exempt(device: str = "cpu") -> Dict[str, str]:
    """The justified exemptions for a sweep on ``device`` ('cpu' or
    'cuda'): on the card ``native.build`` is taken when the kernels
    load, so no site is exempt there."""
    return {} if str(device).startswith("cuda") \
        else dict(CORROBORATION_EXEMPT)


GUARD_MAP_SCHEMA_VERSION = 1

#: try-shaped statements (``except*`` arrives in 3.11)
_TRY_TYPES = (ast.Try,) + ((ast.TryStar,)
                           if hasattr(ast, "TryStar") else ())

_DECL_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)\s*$")
_PRAGMA_RE = re.compile(r"#\s*raceguard:\s*([A-Za-z_-]+)\s*\((.*)\)")
_PRAGMA_ANY_RE = re.compile(r"#\s*raceguard:")
_PRAGMA_VERBS = ("unguarded", "callback-ok")
_MIN_JUSTIFICATION = 20


class GuardBinding:
    """One guard: a named lock bound to a class attribute or a module
    global, plus the attribute set inferred/declared as guarded by it
    (class scope only — module globals are mapped for corroboration
    but not access-checked; the hot-path convention there is the
    documented lock-free published read)."""

    __slots__ = ("site", "kind", "guard", "scope", "line", "attributes")

    def __init__(self, site: str, kind: str, guard: str, scope: str,
                 line: int):
        self.site = site
        self.kind = kind            # lock | rlock | condition
        self.guard = guard          # attribute or global name
        self.scope = scope          # class name, or "" for module scope
        self.line = int(line)
        self.attributes: Set[str] = set()

    def as_dict(self) -> dict:
        return {"guard": self.guard, "kind": self.kind,
                "scope": self.scope or "module",
                "attributes": sorted(self.attributes)}

    def __repr__(self):
        where = self.scope or "module"
        return (f"<guard {self.guard!r} site={self.site!r} {where} "
                f"attrs={sorted(self.attributes)}>")


class _Access:
    __slots__ = ("attr", "write", "line", "held", "in_init")

    def __init__(self, attr, write, line, held, in_init):
        self.attr = attr
        self.write = write
        self.line = line
        self.held = held            # FrozenSet[str] of guard attrs
        self.in_init = in_init


class _Raw:
    """A raw finding before lint.py wraps it in its Finding class (the
    two modules share one parsed tree per file, and lint owns pragma
    filtering + the public type)."""

    __slots__ = ("line", "rule", "message")

    def __init__(self, line: int, rule: str, message: str):
        self.line = int(line)
        self.rule = rule
        self.message = message


def _named_ctor_site(expr: ast.AST) -> Optional[Tuple[str, str]]:
    """(site, kind) if the expression contains a named_* constructor
    call with a literal site anywhere in its subtree."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if name in GUARD_CTORS and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                return node.args[0].value, GUARD_CTORS[name]
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _subscript_base_attr(node: ast.Subscript) -> Optional[str]:
    """``self.d[k]`` / ``self.d[k][j]`` → ``d`` (the store mutates the
    object the attribute publishes, so it counts as a write of the
    attribute for inference and checking)."""
    v = node.value
    while isinstance(v, ast.Subscript):
        v = v.value
    return _self_attr(v)


def _callback_name(call: ast.Call) -> Optional[str]:
    """The callback-ish name a call invokes, or None."""
    f = call.func
    name = None
    if isinstance(f, ast.Name):
        name = f.id
    elif isinstance(f, ast.Attribute):
        name = f.attr
    if name is None:
        return None
    if name in CALLBACK_METHODS or name in _CALLBACK_NAMES \
            or (name.endswith(_CALLBACK_SUFFIX)
                and name != _CALLBACK_SUFFIX):
        return name
    return None


def _comments(source: str) -> Dict[int, str]:
    """line → real comment text, via :mod:`tokenize` — a pragma quoted
    inside a docstring or an error-message literal (this module is full
    of them) must not count as an annotation."""
    import io
    import tokenize
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass                    # ast parsed it; best-effort comments
    return out


def _source_annotations(source: str):
    """(declarations, pragmas, raw_findings): line → guard name for
    ``# guarded-by:``, line → {verb} for VALID ``# raceguard:`` pragmas,
    plus guard-declare findings for malformed/under-justified ones."""
    decls: Dict[int, str] = {}
    pragmas: Dict[int, Set[str]] = {}
    raw: List[_Raw] = []
    if "guarded-by:" not in source and "raceguard:" not in source:
        return decls, pragmas, raw
    for i, text in sorted(_comments(source).items()):
        m = _DECL_RE.search(text)
        if m:
            decls[i] = m.group(1)
        if not _PRAGMA_ANY_RE.search(text):
            continue
        pm = _PRAGMA_RE.search(text)
        if pm is None:
            raw.append(_Raw(
                i, "guard-declare",
                "malformed raceguard pragma — expected "
                "'# raceguard: unguarded(<justification>)' or "
                "'# raceguard: callback-ok(<justification>)'"))
            continue
        verb, justification = pm.group(1), pm.group(2).strip()
        if verb not in _PRAGMA_VERBS:
            raw.append(_Raw(
                i, "guard-declare",
                f"unknown raceguard pragma verb {verb!r} — valid verbs: "
                f"{', '.join(_PRAGMA_VERBS)}"))
            continue
        if len(justification) < _MIN_JUSTIFICATION:
            raw.append(_Raw(
                i, "guard-declare",
                f"raceguard pragma justification must explain WHY the "
                f"access is safe (>= {_MIN_JUSTIFICATION} chars), got "
                f"{justification!r}"))
            continue
        pragmas.setdefault(i, set()).add(verb)
    return decls, pragmas, raw


# -------------------------------------------------------------- class pass

class _ClassAnalyzer:
    """Two sub-passes over one ClassDef: record every access with its
    lexically-held guard set, then infer the guarded set and emit
    findings.  The traversal tracks:

    - ``with self._g:`` blocks (any number of items, aliased or not);
    - the blessed bounded-acquire form (``got = self._g.acquire(...)``
      immediately followed by ``try``) — its try/else/finally bodies
      count as held, mirroring mxlint's ``naked-acquire`` contract;
    - nested functions/lambdas, which RESET the held set (a closure
      built under a lock usually runs after release) unless their
      ``def`` line carries a ``guarded-by:`` declaration;
    - reentrant re-``with`` of the same guard (RLock style), which is
      naturally idempotent in a lexical set.
    """

    def __init__(self, cls: ast.ClassDef, decls: Dict[int, str],
                 findings: List[_Raw]):
        self.cls = cls
        self.decls = decls
        self.findings = findings
        self.guards: Dict[str, GuardBinding] = {}
        self.accesses: List[_Access] = []
        self.calls: List[Tuple[str, int, FrozenSet[str]]] = []
        self.decl_used: Set[int] = set()
        self._in_init = False

    # ---- pass 1: bind guards + attach declarations
    def bind(self, assigns: Sequence[ast.stmt]) -> None:
        """``assigns``: the assignments of this class's methods, method
        by method, each method's in ``ast.walk`` order."""
        for stmt in assigns:
            if stmt.value is None:
                continue
            found = _named_ctor_site(stmt.value)
            if found is None:
                continue
            site, kind = found
            for t in _targets(stmt):
                attr = _self_attr(t)
                if attr is not None and attr not in self.guards:
                    self.guards[attr] = GuardBinding(
                        site, kind, attr, self.cls.name, stmt.lineno)

    def _methods(self):
        for node in self.cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    # ---- pass 2: record accesses under the lexical held set
    def record(self) -> None:
        for meth in self._methods():
            self._in_init = meth.name == "__init__"
            held = self._decl_held(meth.lineno, frozenset())
            self._walk_body(meth.body, held)

    def _decl_held(self, line: int,
                   base: FrozenSet[str]) -> FrozenSet[str]:
        """Apply a ``guarded-by:`` declaration sitting on a def line."""
        g = self.decls.get(line)
        if g is None:
            return base
        self.decl_used.add(line)
        if g not in self.guards:
            self.findings.append(_Raw(
                line, "guard-declare",
                f"guarded-by declaration names {g!r}, which is not a "
                f"named-lock guard of class {self.cls.name} "
                f"(known guards: {sorted(self.guards) or 'none'})"))
            return base
        return base | {g}

    def _bounded_acquire_guard(self, stmt: ast.stmt) -> Optional[str]:
        """``got = self._g.acquire(...)`` (or bare expression form) —
        the one blessed non-``with`` acquire (see mxlint
        ``naked-acquire``)."""
        value = stmt.value if isinstance(stmt, (ast.Assign, ast.Expr)) \
            else None
        if isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Attribute) \
                and value.func.attr == "acquire":
            attr = _self_attr(value.func.value)
            if attr in self.guards:
                return attr
        return None

    def _walk_body(self, stmts: Sequence[ast.stmt],
                   held: FrozenSet[str]) -> None:
        i = 0
        while i < len(stmts):
            stmt = stmts[i]
            g = self._bounded_acquire_guard(stmt)
            if g is not None and i + 1 < len(stmts) \
                    and isinstance(stmts[i + 1], _TRY_TYPES):
                self._visit_stmt(stmt, held)
                t = stmts[i + 1]
                inner = held | {g}
                self._walk_body(t.body, inner)
                for h in t.handlers:
                    self._walk_body(h.body, inner)
                self._walk_body(t.orelse, inner)
                self._walk_body(t.finalbody, inner)
                i += 2
                continue
            self._visit_stmt(stmt, held)
            i += 1

    def _with_guards(self, node) -> FrozenSet[str]:
        got: Set[str] = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.guards:
                got.add(attr)
        return frozenset(got)

    def _visit_stmt(self, stmt: ast.stmt, held: FrozenSet[str]) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._visit_expr(item.context_expr, held)
                if item.optional_vars is not None:
                    self._visit_expr(item.optional_vars, held)
            self._walk_body(stmt.body, held | self._with_guards(stmt))
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in stmt.decorator_list:
                self._visit_expr(dec, held)
            inner = self._decl_held(stmt.lineno, frozenset())
            self._walk_body(stmt.body, inner)
            return
        if isinstance(stmt, ast.ClassDef):
            return                        # nested class: its own world
        if isinstance(stmt, _TRY_TYPES):
            self._walk_body(stmt.body, held)
            for h in stmt.handlers:
                if h.type is not None:
                    self._visit_expr(h.type, held)
                self._walk_body(h.body, held)
            self._walk_body(stmt.orelse, held)
            self._walk_body(stmt.finalbody, held)
            return
        if isinstance(stmt, ast.Match):
            self._visit_expr(stmt.subject, held)
            for case in stmt.cases:
                if case.guard is not None:
                    self._visit_expr(case.guard, held)
                self._walk_body(case.body, held)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._visit_expr(stmt.test, held)
            self._walk_body(stmt.body, held)
            self._walk_body(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_expr(stmt.target, held)
            self._visit_expr(stmt.iter, held)
            self._walk_body(stmt.body, held)
            self._walk_body(stmt.orelse, held)
            return
        # leaf statement: visit every contained expression
        for field in ast.iter_child_nodes(stmt):
            self._visit_expr(field, held)

    def _visit_expr(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, ast.Lambda):
            self._visit_expr(node.body, frozenset())
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            self._visit_stmt(node, held)
            return
        attr = _self_attr(node)
        if attr is not None:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            self.accesses.append(_Access(attr, write, node.lineno, held,
                                         self._in_init))
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            base = _subscript_base_attr(node)
            if base is not None:
                self.accesses.append(_Access(base, True, node.lineno,
                                             held, self._in_init))
        if isinstance(node, ast.Call):
            cb = _callback_name(node)
            if cb is not None and held:
                self.calls.append((cb, node.lineno, held))
        for child in ast.iter_child_nodes(node):
            self._visit_expr(child, held)

    # ---- pass 3: infer + check
    def infer(self, attr_decls: Dict[str, Tuple[str, int]]) -> None:
        """``attr_decls``: attr → (guard, decl line) from ``guarded-by``
        declarations on ``self.attr = ...`` lines of this class."""
        inferred: Dict[str, Set[str]] = {}
        for a in self.accesses:
            if a.write and not a.in_init and a.held \
                    and a.attr not in self.guards:
                inferred.setdefault(a.attr, set()).update(a.held)
        for attr, (guard, line) in attr_decls.items():
            if guard not in self.guards:
                self.findings.append(_Raw(
                    line, "guard-declare",
                    f"guarded-by declaration names {guard!r}, which is "
                    f"not a named-lock guard of class {self.cls.name} "
                    f"(known guards: {sorted(self.guards) or 'none'})"))
                continue
            inferred[attr] = {guard}      # explicit beats inferred
        self.guarded: Dict[str, Set[str]] = inferred
        for attr, gs in inferred.items():
            for g in gs:
                self.guards[g].attributes.add(attr)

    def check(self) -> None:
        seen: Set[Tuple[int, str, str]] = set()
        for a in self.accesses:
            if a.in_init or a.attr not in self.guarded:
                continue
            guards = self.guarded[a.attr]
            if a.held & guards:
                continue
            key = (a.line, a.attr, "w" if a.write else "r")
            if key in seen:
                continue
            seen.add(key)
            glist = ", ".join(
                f"self.{g} ({self.guards[g].site})"
                for g in sorted(guards))
            kind = "write to" if a.write else "read of"
            self.findings.append(_Raw(
                a.line, "guarded-by",
                f"{kind} self.{a.attr} outside its guard — "
                f"{self.cls.name}.{a.attr} is guarded by {glist}; hold "
                f"the lock, declare a caller-holds contract with "
                f"'# guarded-by: <guard>' on the def, or justify with "
                f"'# raceguard: unguarded(<why>)'"))
        for cb, line, held in self.calls:
            sites = ", ".join(
                f"self.{g} ({self.guards[g].site})" for g in sorted(held))
            self.findings.append(_Raw(
                line, "callback-under-lock",
                f"{cb}() invoked while holding {sites} — future "
                f"resolution / user callbacks run foreign code inside "
                f"the critical section (the static analogue of the "
                f"witness's 'blocking' finding); resolve outside the "
                f"lock or justify with "
                f"'# raceguard: callback-ok(<why>)'"))


# ------------------------------------------------------------- module pass

class ModuleGuards:
    """Everything raceguard learned about one module: the per-class and
    module-level guard bindings (for the guard map) and the raw
    findings (for the linter)."""

    __slots__ = ("path", "bindings", "findings")

    def __init__(self, path: str):
        self.path = path
        self.bindings: List[GuardBinding] = []
        self.findings: List[_Raw] = []


def _module_pass(tree: ast.Module, out: ModuleGuards) -> None:
    """Module-level guards: ``_LOCK = named_lock(...)`` at top level,
    guarding the globals written under ``with _LOCK:`` in module
    functions.  Mapped for corroboration; not access-checked — the
    module-global pattern here is deliberately lock-free on read paths
    (single-reference published reads)."""
    guards: Dict[str, GuardBinding] = {}
    module_names: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            module_names.add(stmt.targets[0].id)
            found = _named_ctor_site(stmt.value)
            if found is not None:
                site, kind = found
                name = stmt.targets[0].id
                guards.setdefault(name, GuardBinding(
                    site, kind, name, "", stmt.lineno))
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            module_names.add(stmt.target.id)
    if not guards:
        return

    def scan(body, held: FrozenSet[str], globals_declared: Set[str]):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                gd = set(globals_declared)
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Global):
                        gd.update(sub.names)
                scan(stmt.body, frozenset(), gd)
            elif isinstance(stmt, ast.ClassDef):
                # methods may take MODULE locks too (e.g. a plan
                # registering itself under the module's swap lock) —
                # scan them for module-global writes; self.* state is
                # the class pass's job
                scan(stmt.body, frozenset(), globals_declared)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                got = {item.context_expr.id for item in stmt.items
                       if isinstance(item.context_expr, ast.Name)
                       and item.context_expr.id in guards}
                scan(stmt.body, held | frozenset(got), globals_declared)
            elif isinstance(stmt, _TRY_TYPES):
                scan(stmt.body, held, globals_declared)
                for h in stmt.handlers:
                    scan(h.body, held, globals_declared)
                scan(stmt.orelse, held, globals_declared)
                scan(stmt.finalbody, held, globals_declared)
            elif isinstance(stmt, ast.Match):
                for case in stmt.cases:
                    scan(case.body, held, globals_declared)
            elif isinstance(stmt, (ast.If, ast.While, ast.For,
                                   ast.AsyncFor)):
                scan(stmt.body, held, globals_declared)
                scan(stmt.orelse, held, globals_declared)
            elif held:
                writable = globals_declared | module_names
                for node in ast.walk(stmt):
                    name = None
                    if isinstance(node, ast.Name) \
                            and isinstance(node.ctx,
                                           (ast.Store, ast.Del)) \
                            and node.id in globals_declared:
                        name = node.id
                    elif isinstance(node, ast.Subscript) \
                            and isinstance(node.ctx,
                                           (ast.Store, ast.Del)):
                        base = node.value
                        while isinstance(base, ast.Subscript):
                            base = base.value
                        if isinstance(base, ast.Name) \
                                and base.id in writable:
                            name = base.id
                    if name is not None:
                        for g in held:
                            guards[g].attributes.add(name)

    scan(tree.body, frozenset(), set())
    out.bindings.extend(guards.values())


def _targets(stmt: ast.stmt) -> List[ast.expr]:
    return stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]


_BODY_FIELDS = ("body", "handlers", "orelse", "finalbody", "cases")


def _class_assignments(tree: ast.Module):
    """[(ClassDef, assignments)] for every class of ``tree`` in
    ``ast.walk`` order; a class's assignments are those of its methods
    (nested functions and classes included), method by method, each in
    ``ast.walk`` order.  One breadth-first walk over the statements
    alone: classes and assignments are statements, whose ancestors are
    statements, handlers and match cases only, so this walk keeps
    ``ast.walk``'s relative order without visiting an expression."""
    classes = []
    queue = collections.deque([(tree, ())])
    while queue:
        node, owners = queue.popleft()
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            for per_method in owners:
                per_method.append(node)
        methods = None
        if isinstance(node, ast.ClassDef):
            methods = []
            classes.append((node, methods))
        for field in _BODY_FIELDS:
            block = getattr(node, field, None)
            if not block:
                continue
            for child in block:
                if methods is not None and field == "body" \
                        and isinstance(child, (ast.FunctionDef,
                                               ast.AsyncFunctionDef)):
                    methods.append([])
                    queue.append((child, owners + (methods[-1],)))
                else:
                    queue.append((child, owners))
    return [(cls, [a for m in methods for a in m])
            for cls, methods in classes]


def analyze_module(path: str, tree: ast.Module,
                   source: str) -> ModuleGuards:
    """Run the whole raceguard pass over one already-parsed module.
    Called by ``lint.run_lint`` on the shared per-file parse; usable
    standalone for the guard map."""
    out = ModuleGuards(path)
    decls, pragmas, raw = _source_annotations(source)
    out.findings.extend(raw)
    # every guard comes from a named_* constructor: a module that names
    # none and declares nothing has no guard, access or finding to find
    if not decls and "named_" not in source:
        return out

    decl_lines_used: Set[int] = set()
    for node, assigns in _class_assignments(tree):
        ca = _ClassAnalyzer(node, decls, out.findings)
        ca.bind(assigns)
        if not ca.guards and not decls:
            continue            # nothing can be held, inferred or declared
        ca.record()
        # attribute-level declarations: a `# guarded-by:` on a
        # `self.attr = ...` line inside this class
        attr_decls: Dict[str, Tuple[str, int]] = {}
        for stmt in assigns:
            if stmt.lineno in decls:
                for t in _targets(stmt):
                    attr = _self_attr(t)
                    if attr is not None:
                        attr_decls[attr] = (decls[stmt.lineno],
                                            stmt.lineno)
                        decl_lines_used.add(stmt.lineno)
        decl_lines_used.update(ca.decl_used)
        ca.infer(attr_decls)
        ca.check()
        out.bindings.extend(ca.guards.values())

    _module_pass(tree, out)

    for line, guard in decls.items():
        if line not in decl_lines_used:
            out.findings.append(_Raw(
                line, "guard-declare",
                f"orphan guarded-by declaration ({guard!r}) — it must "
                f"sit on a 'self.attr = ...' assignment or a 'def' line "
                f"inside a class with named-lock guards"))

    # pragma suppression: a VALIDATED pragma eats its rule's findings
    # on that line (invalid pragmas never suppress — they are findings)
    kept: List[_Raw] = []
    for f in out.findings:
        verbs = pragmas.get(f.line, set())
        if f.rule == "guarded-by" and "unguarded" in verbs:
            continue
        if f.rule == "callback-under-lock" and "callback-ok" in verbs:
            continue
        kept.append(f)
    out.findings = kept
    return out


# --------------------------------------------------------------- guard map

def build_guard_map(paths: Sequence[str],
                    root: Optional[str] = None) -> dict:
    """The static concurrency contract: every named-lock site in
    ``paths`` → its bindings (module, scope, guard, kind, guarded
    attributes).  Deterministic (sorted keys/lists, forward-slash
    relative module paths) so the checked-in copy
    (``mxnet_tpu_torch/analysis/concurrency_contract.json``)
    regenerates byte-identical.

    ``root`` anchors the relative module paths; default is the common
    parent of ``paths``."""
    from .lint import collect_files      # lint imports us lazily; safe
    files = collect_files(paths)
    if root is None:
        dirs = [p if os.path.isdir(p) else os.path.dirname(p)
                for p in paths]
        root = os.path.commonpath([os.path.abspath(d) for d in dirs]) \
            if dirs else os.getcwd()
    sites: Dict[str, List[dict]] = {}
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue                      # the linter reports it
        mod = analyze_module(path, tree, src)
        rel = os.path.relpath(os.path.abspath(path),
                              os.path.abspath(root)).replace(os.sep, "/")
        for b in mod.bindings:
            d = b.as_dict()
            d["module"] = rel
            sites.setdefault(b.site, []).append(d)
    return {
        "schema_version": GUARD_MAP_SCHEMA_VERSION,
        "generated_by": "mxnet_tpu_torch.analysis.raceguard.build_guard_map",
        "sites": {
            site: {"bindings": sorted(
                bindings,
                key=lambda d: (d["module"], d["scope"], d["guard"]))}
            for site, bindings in sorted(sites.items())
        },
    }


def corroborate(guard_map: dict, per_site: Dict[str, int],
                exempt: Optional[Dict[str, str]] = None) -> dict:
    """Diff the static guard map against a witness acquisition dump
    (``LockWitness.report()["per_site"]``).  Returns a JSON-able verdict:

    - ``unexercised``: sites the map claims but the run never acquired
      (minus justified :data:`CORROBORATION_EXEMPT` entries) — a guard
      nobody locks is an unproven contract;
    - ``unmapped``: sites the witness acquired that the map does not
      know — runtime locks the static analysis cannot see (a dynamic
      site name, or a module the map build skipped).

    ``passed`` iff both lists are empty."""
    exempt = CORROBORATION_EXEMPT if exempt is None else exempt
    mapped = set(guard_map.get("sites", {}))
    witnessed = {s for s, n in per_site.items() if n > 0}
    unexercised = sorted(mapped - witnessed - set(exempt))
    unmapped = sorted(witnessed - mapped)
    return {
        "passed": not unexercised and not unmapped,
        "mapped_sites": len(mapped),
        "witnessed_sites": len(witnessed),
        "unexercised": unexercised,
        "unmapped": unmapped,
        "exempt": {s: j for s, j in sorted(exempt.items())
                   if s in mapped},
        "acquisitions_per_mapped_site": {
            s: per_site.get(s, 0) for s in sorted(mapped)},
    }
