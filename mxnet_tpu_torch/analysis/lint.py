"""mxlint — the AST project linter behind ``tools/mxlint_torch.py``,
the counterpart of ``mxnet_tpu/analysis/lint.py`` with the same rules,
scopes, pragmas and messages.

Contracts nothing else checks mechanically: fault-injection sites are
stringly typed, metric names follow a convention, the serving/fleet
error taxonomy is hand-maintained, lock discipline is a convention,
and the named-lock stack's *guarded-by* relation (which
attribute belongs to which lock) is implicit.  Each rule here codifies
one of those contracts (docs/static_analysis.md has the catalog with
rationale):

``fault-site``
    Every site literal fired through ``inject``/``poison`` (and
    targeted by :class:`FaultPlan`'s ``*_at`` methods) must be declared in
    ``faults.KNOWN_SITES`` via ``register_site`` — a typo'd site is
    silently dead chaos coverage.
``metric-name``
    Every complete ``mxtpu_*`` metric-name literal must match
    ``mxtpu_[a-z0-9_]+`` AND appear in the docs/observability.md
    catalog (templated entries like ``mxtpu_serving_<counter>_total``
    match as families) — an undocumented metric is invisible to the
    fleet scraper's dashboards.
``span-name``
    Every complete ``serving.*``/``fleet.*``/``loop.*`` span or
    flight-recorder event-name literal must appear in the
    docs/observability.md taxonomy tables — mirroring ``metric-name``,
    so recording an event and documenting it stay one change (an
    undocumented event is a timeline entry no operator can look up).
``typed-raise``
    No bare ``ValueError``/``RuntimeError``/``KeyError``/``TypeError``/
    ``Exception`` raised inside ``serving/`` or ``fleet/`` — every
    failure a caller can see must be MXNetError-typed
    (docs/serving.md error taxonomy).
``naked-acquire``
    Locks are acquired via ``with``; a bare ``.acquire()`` is allowed
    only when the IMMEDIATELY following statement is a ``try`` whose
    ``finally`` releases the same object — anything else leaks the lock
    on the first exception between acquire and release.
``wall-clock``
    No ``time.time()`` inside the components that follow the
    monotonic-clock convention (``serving``, ``fleet``, ``resilience``,
    ``observability``, ``analysis``) — NTP steps wall clocks backwards,
    which turns deadline/ordering arithmetic into negative durations.
``lock-allowlist``
    The lockwitness allowlist file must be well-formed: known kinds,
    sites that exist (statically collected from ``named_lock``/
    ``named_rlock``/``named_condition``/``note_blocking`` literals),
    and a real justification string per entry — the escape hatch is
    itself under analysis.
``guarded-by`` / ``guard-declare`` / ``callback-under-lock``
    The raceguard pass (:mod:`~mxnet_tpu_torch.analysis.raceguard`): every
    attribute written under a named lock belongs to that lock, and any
    access reached outside it is a statically-detected race; its
    declaration/pragma grammar is validated; and resolving futures or
    invoking user callbacks while a guard is held is flagged as the
    static analogue of the lockwitness ``blocking`` finding.

All rules run over ONE shared parse and ONE node index per file (a
single ``ast.walk``) — adding a rule must not add a tree traversal;
the wall-time contract over the full package is pinned in
``tests/test_torch_analysis.py``.

Suppression: append ``# mxlint: disable=<rule>[,<rule>...]`` to the
offending line (``disable=all`` silences every rule for that line).
The raceguard rules prefer their own *justified* pragmas
(``# raceguard: unguarded(<why>)`` / ``callback-ok(<why>)``) — those
carry a validated >= 20-char justification, so use them instead of the
bare disable.  Use sparingly; every pragma needs its reason.

The linter is PURELY static — it parses source with :mod:`ast` and
never imports the code under analysis, so it runs without torch or a
device."""
from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import raceguard as _raceguard

__all__ = ["Finding", "FileIndex", "RULES", "run_lint", "collect_files"]

RULES: Dict[str, str] = {
    "fault-site": "fault site literal not registered in faults.KNOWN_SITES",
    "metric-name": "metric literal violates mxtpu_* naming or is missing "
                   "from the docs/observability.md catalog",
    "span-name": "span/flight-recorder event name literal missing from "
                 "the docs/observability.md taxonomy tables",
    "typed-raise": "untyped exception raised on a serving/fleet path "
                   "(must be MXNetError-typed)",
    "naked-acquire": "lock acquired outside `with` without a matching "
                     "try/finally release",
    "wall-clock": "time.time() used where the monotonic-clock convention "
                  "applies",
    "lock-allowlist": "malformed lockwitness allowlist entry",
}
RULES.update(_raceguard.RACEGUARD_RULES)

#: component directories where the monotonic-clock convention applies
WALL_CLOCK_SCOPE = ("serving", "fleet", "resilience", "observability",
                    "analysis", "data")
#: component directories where raises must be MXNetError-typed
TYPED_RAISE_SCOPE = ("serving", "fleet", "data")
#: exception names considered untyped on those paths
UNTYPED_RAISES = ("ValueError", "RuntimeError", "KeyError", "TypeError",
                  "IndexError", "Exception")

#: call names whose first positional string argument is a fault site
FAULT_SITE_CALLS = ("inject", "_inject", "poison", "_poison", "maybe_fire",
                    "_run_step")
#: FaultPlan methods whose first argument is a fault site
FAULT_PLAN_BUILDERS = ("raise_at", "delay_at", "kill_at", "call_at",
                       "nonfinite_at", "corrupt_at")
#: lockwitness constructors whose first argument is a lock site
LOCK_SITE_CALLS = ("named_lock", "named_rlock", "named_condition",
                   "_named_lock", "_named_rlock", "_named_condition")

#: call names whose first positional string argument is a span or
#: flight-recorder event name (Tracer.span/record_span/event,
#: FlightRecorder.record/trigger/dump, ``tr.event``-style wrappers) —
#: the span-name rule only fires when that argument ALSO matches
#: _SPAN_NAME_RE, so e.g. ``autograd.record()`` (no args) and
#: ``metrics.span("prefill")`` (bare phase word) are never candidates
SPAN_NAME_CALLS = ("span", "record_span", "event", "record", "trigger",
                   "dump")
#: a COMPLETE span/event name in the enforced namespaces — the same
#: components whose fault sites and error taxonomy are already linted
_SPAN_NAME_RE = re.compile(r"^(?:serving|fleet|loop)\.[a-z0-9_]+$")
#: backticked span/event tokens in the docs taxonomy tables
_SPAN_DOC_RE = re.compile(r"`((?:serving|fleet|loop)\.[a-z0-9_]+)`")

METRIC_RE = re.compile(r"^mxtpu_[a-z0-9_]+$")
_METRIC_DOC_RE = re.compile(r"mxtpu_[a-z0-9_<>]*[a-z0-9_>]")
_PRAGMA_RE = re.compile(r"#\s*mxlint:\s*disable=([a-zA-Z0-9_,\- ]+)")

ALLOWLIST_KINDS = ("cycle", "blocking", "same_site")

#: statement-list owners the FileIndex collects blocks from
#: (``except*`` arrives in 3.11; ``match`` cases are handled apart)
_BLOCK_NODES = (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef,
                ast.ClassDef, ast.With, ast.AsyncWith, ast.If, ast.While,
                ast.For, ast.AsyncFor, ast.Try) + (
                    (ast.TryStar,) if hasattr(ast, "TryStar") else ())


class Finding:
    """One lint violation: where, which rule, and why."""

    __slots__ = ("path", "line", "rule", "message")

    def __init__(self, path: str, line: int, rule: str, message: str):
        self.path = path
        self.line = int(line)
        self.rule = rule
        self.message = message

    def __repr__(self):
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into the .py list to lint."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            raise FileNotFoundError(p)
    return out


def _component(path: str) -> Optional[str]:
    """The component directory a file lives in (``serving``, ``fleet``,
    …): the segment after the LAST ``mxnet_tpu_torch`` path element — a
    checkout directory itself named ``mxnet_tpu_torch`` must not shadow
    the package root and silently widen/disable the scoped rules."""
    parts = os.path.normpath(path).split(os.sep)
    for i in range(len(parts) - 2, -1, -1):
        if parts[i] == "mxnet_tpu_torch":
            nxt = parts[i + 1]
            return None if nxt.endswith(".py") else nxt
    # fixture trees: treat the immediate parent directory as component
    return parts[-2] if len(parts) >= 2 else None


def _pragmas(source: str) -> Dict[int, Set[str]]:
    """line number → rules disabled on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), 1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _str_arg(call: ast.Call) -> Optional[Tuple[str, int]]:
    """The first positional argument if it is a plain string literal."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value, call.args[0].lineno
    return None


def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


# ------------------------------------------------------- shared file index

#: fields that hold only operator and load/store leaves, which no rule reads
_LEAF_FIELDS = ("ctx", "op", "ops")
_WALK_FIELDS: Dict[type, Tuple[str, ...]] = {}


def _walk(tree: ast.AST) -> List[ast.AST]:
    """The nodes of ``tree`` in ``ast.walk``'s order, less the operator
    and context leaves, without ``ast.walk``'s per-node generators (a
    third of its time on this package)."""
    nodes = [tree]
    for node in nodes:          # grows as it goes: breadth first
        kind = type(node)
        fields = _WALK_FIELDS.get(kind)
        if fields is None:
            fields = _WALK_FIELDS[kind] = tuple(
                f for f in kind._fields if f not in _LEAF_FIELDS)
        for name in fields:
            value = getattr(node, name, None)
            if isinstance(value, ast.AST):
                nodes.append(value)
            elif isinstance(value, list):
                nodes.extend([v for v in value if isinstance(v, ast.AST)])
    return nodes


class FileIndex:
    """One parse + ONE walk per file; every rule reads the node
    lists it needs from here instead of re-walking the tree.  The
    raceguard pass shares ``tree``/``source`` (its class-structured
    traversal is not expressible as flat node lists, but it re-parses
    nothing)."""

    __slots__ = ("path", "tree", "source", "component", "pragmas",
                 "calls", "str_constants", "raises", "blocks")

    def __init__(self, path: str, tree: ast.Module, source: str):
        self.path = path
        self.tree = tree
        self.source = source
        self.component = _component(path)
        self.pragmas = _pragmas(source)
        calls: List[ast.Call] = []
        consts: List[ast.Constant] = []
        raises: List[ast.Raise] = []
        blocks: List[List[ast.stmt]] = []
        for node in _walk(tree):
            if isinstance(node, ast.Call):
                calls.append(node)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                consts.append(node)
            elif isinstance(node, ast.Raise):
                raises.append(node)
            if isinstance(node, _BLOCK_NODES):
                for field in ("body", "orelse", "finalbody"):
                    block = getattr(node, field, None)
                    if isinstance(block, list) and block \
                            and isinstance(block[0], ast.stmt):
                        blocks.append(block)
                for handler in getattr(node, "handlers", []) or []:
                    if handler.body:
                        blocks.append(handler.body)
            elif isinstance(node, ast.Match):
                for case in node.cases:
                    if case.body:
                        blocks.append(case.body)
        self.calls = calls
        self.str_constants = consts
        self.raises = raises
        self.blocks = blocks


# --------------------------------------------------------- site collection

def collect_registered_fault_sites(indexes: Sequence[FileIndex]) -> Set[str]:
    """Every ``register_site("...")`` literal in the scanned tree — the
    static mirror of ``faults.KNOWN_SITES`` (faults.py declares the
    in-tree sites with exactly these calls) — PLUS the in-package
    faults.py registry itself, so a partial lint
    (``mxlint_torch.py mxnet_tpu_torch/serving/engine.py``) that does not scan
    faults.py still knows the real sites instead of flagging every
    legitimate literal."""
    sites: Set[str] = set()
    call_lists = [idx.calls for idx in indexes]
    faults_py = os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "resilience",
        "faults.py"))
    if os.path.exists(faults_py) \
            and not any(os.path.abspath(idx.path) == faults_py
                        for idx in indexes):
        try:
            with open(faults_py, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            call_lists.append([n for n in ast.walk(tree)
                               if isinstance(n, ast.Call)])
        except (OSError, SyntaxError):
            pass
    for calls in call_lists:
        for node in calls:
            if _call_name(node) == "register_site":
                lit = _str_arg(node)
                if lit:
                    sites.add(lit[0])
    return sites


def collect_lock_sites(indexes: Sequence[FileIndex]) -> Set[str]:
    """Every lock/blocking site constructed in the scanned tree:
    ``named_*`` first args (+ their ``.wait`` blocking names) and
    ``note_blocking`` literals."""
    sites: Set[str] = set()
    for idx in indexes:
        for node in idx.calls:
            name = _call_name(node)
            lit = _str_arg(node)
            if lit is None:
                continue
            if name in LOCK_SITE_CALLS:
                sites.add(lit[0])
                sites.add(lit[0] + ".wait")
            elif name in ("note_blocking", "_note_blocking"):
                sites.add(lit[0])
    return sites


def _doc_span_catalog(doc_path: Optional[str]) -> Optional[Set[str]]:
    """Every backticked ``serving.*``/``fleet.*``/``loop.*`` token in
    docs/observability.md — the span/event taxonomy the ``span-name``
    rule enforces.  Recording an event and documenting it are one
    change, mirroring the metric-name rule."""
    if not doc_path or not os.path.exists(doc_path):
        return None
    with open(doc_path, encoding="utf-8") as f:
        return set(_SPAN_DOC_RE.findall(f.read()))


def _doc_catalog(doc_path: Optional[str]):
    """Parse docs/observability.md into (exact-name set, template-regex
    list).  ``mxtpu_serving_<counter>_total`` becomes a family regex."""
    exact: Set[str] = set()
    families: List[re.Pattern] = []
    if not doc_path or not os.path.exists(doc_path):
        return None
    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    for tok in set(_METRIC_DOC_RE.findall(text)):
        if "<" in tok:
            # templated family: mxtpu_serving_<counter>_total
            pat = re.sub(r"<[a-z0-9_]+>", "[a-z0-9_]+", re.escape(tok))
            families.append(re.compile("^" + pat + "$"))
        else:
            exact.add(tok)
    return exact, families


def _find_repo_root(paths: Sequence[str]) -> Optional[str]:
    """Walk up from the first path to a directory holding docs/."""
    cur = os.path.abspath(paths[0] if paths else ".")
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    for _ in range(10):
        if os.path.isdir(os.path.join(cur, "docs")):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return None
        cur = nxt
    return None


# ----------------------------------------------------------------- checks

def _check_fault_sites(idx: FileIndex, known: Set[str], findings):
    for node in idx.calls:
        name = _call_name(node)
        if name in FAULT_SITE_CALLS or name in FAULT_PLAN_BUILDERS:
            lit = _str_arg(node)
            if lit is None:
                continue            # dynamic site: runtime check owns it
            site, line = lit
            base = site.split("@", 1)[0]
            if base not in known:
                findings.append(Finding(
                    idx.path, line, "fault-site",
                    f"fault site {site!r} is not registered in "
                    f"faults.KNOWN_SITES — a typo'd site is silently "
                    f"dead chaos coverage; declare it with "
                    f"register_site()"))


def _check_metric_names(idx: FileIndex, catalog, findings):
    for node in idx.str_constants:
        v = node.value
        # a CANDIDATE metric name: mxtpu_ + word chars only.  Thread
        # names ('mxtpu-digest'), filenames ('mxtpu_io.cc'), prose and
        # prefix fragments ('mxtpu_serving_') are not metric literals.
        if not re.match(r"^mxtpu_[A-Za-z0-9_]+$", v) or v.endswith("_"):
            continue
        if not METRIC_RE.match(v):
            findings.append(Finding(
                idx.path, node.lineno, "metric-name",
                f"metric literal {v!r} violates the mxtpu_[a-z0-9_]+ "
                f"naming convention"))
            continue
        if catalog is None:
            continue
        exact, families = catalog
        if v in exact or any(f.match(v) for f in families):
            continue
        findings.append(Finding(
            idx.path, node.lineno, "metric-name",
            f"metric {v!r} is not in the docs/observability.md catalog "
            f"— undocumented metrics are invisible to fleet dashboards"))


def _check_span_names(idx: FileIndex, span_catalog: Optional[Set[str]],
                      findings):
    """``span-name`` (docs/static_analysis.md): a COMPLETE
    ``serving.*``/``fleet.*``/``loop.*`` literal passed as the span or
    flight-recorder event name must appear in the
    docs/observability.md taxonomy tables — an undocumented event is a
    timeline entry (or a flight-bundle trigger) no operator can look
    up at 3am.  Dynamic names and names outside the three enforced
    namespaces are the runtime's problem, not this rule's."""
    if span_catalog is None:
        return
    for node in idx.calls:
        if _call_name(node) not in SPAN_NAME_CALLS:
            continue
        lit = _str_arg(node)
        if lit is None:
            continue
        name, line = lit
        if not _SPAN_NAME_RE.match(name):
            continue
        if name in span_catalog:
            continue
        findings.append(Finding(
            idx.path, line, "span-name",
            f"span/event name {name!r} is not in the "
            f"docs/observability.md taxonomy tables — record an event "
            f"and document it in one change (backtick it in a taxonomy "
            f"row)"))


def _check_typed_raises(idx: FileIndex, findings):
    comp = idx.component
    if comp not in TYPED_RAISE_SCOPE:
        return
    for node in idx.raises:
        if node.exc is None:
            continue
        exc = node.exc
        name = None
        if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
            name = exc.func.id
        elif isinstance(exc, ast.Name):
            name = exc.id
        if name in UNTYPED_RAISES:
            findings.append(Finding(
                idx.path, node.lineno, "typed-raise",
                f"raise {name} on a {comp}/ path — every failure a "
                f"caller can see must be MXNetError-typed "
                f"(docs/serving.md error taxonomy)"))


def _check_naked_acquire(idx: FileIndex, findings):
    acquires = [node for node in idx.calls
                if isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"]
    if not acquires:
        return
    # allowed shape: `x.acquire()` / `got = x.acquire(timeout=...)` as a
    # statement whose NEXT sibling is a try whose finally releases the
    # same object (a bounded acquire cannot use `with`, so this is the
    # one blessed non-context form)
    allowed = set()
    for block in idx.blocks:
        for i, stmt in enumerate(block):
            if isinstance(stmt, ast.Expr):
                call = stmt.value
            elif isinstance(stmt, ast.Assign):
                call = stmt.value
            else:
                continue
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "acquire"
                    and i + 1 < len(block)
                    and isinstance(block[i + 1], ast.Try)):
                continue
            target = ast.dump(call.func.value)
            for fin in block[i + 1].finalbody:
                for sub in ast.walk(fin):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "release" \
                            and ast.dump(sub.func.value) == target:
                        allowed.add(id(stmt.value))
    seen = set()
    for node in acquires:
        key = (node.lineno, node.col_offset)
        if id(node) in allowed or key in seen:
            continue
        seen.add(key)
        findings.append(Finding(
            idx.path, node.lineno, "naked-acquire",
            "lock acquired outside `with` — an exception between "
            "acquire and release leaks the lock; use `with lock:` "
            "(or acquire immediately followed by try/finally "
            "release)"))


def _check_wall_clock(idx: FileIndex, findings):
    if idx.component not in WALL_CLOCK_SCOPE:
        return
    for node in idx.calls:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "time" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "time":
            findings.append(Finding(
                idx.path, node.lineno, "wall-clock",
                "time.time() where the monotonic-clock convention "
                "applies — NTP steps make wall-clock deltas go "
                "negative; use time.monotonic() (or pragma a genuine "
                "epoch timestamp)"))


def _check_raceguard(idx: FileIndex, findings):
    """The guarded-by pass (docs/static_analysis.md): shares this
    file's parse; its own justified pragmas are applied inside the
    pass, the central ``mxlint: disable`` filter applies after."""
    mod = _raceguard.analyze_module(idx.path, idx.tree, idx.source)
    for r in mod.findings:
        findings.append(Finding(idx.path, r.line, r.rule, r.message))


def check_allowlist(allowlist_path: str, lock_sites: Set[str],
                    findings: List[Finding]) -> None:
    """Validate the lockwitness allowlist file (absent file = nothing
    to validate)."""
    if not os.path.exists(allowlist_path):
        return
    try:
        with open(allowlist_path, encoding="utf-8") as f:
            data = json.load(f)
    except ValueError as e:
        findings.append(Finding(allowlist_path, 1, "lock-allowlist",
                                f"not valid JSON: {e}"))
        return
    entries = data.get("entries") if isinstance(data, dict) else data
    if not isinstance(entries, list):
        findings.append(Finding(
            allowlist_path, 1, "lock-allowlist",
            "expected {\"entries\": [...]} or a top-level list"))
        return
    for i, e in enumerate(entries):
        where = f"entry {i}"
        if not isinstance(e, dict):
            findings.append(Finding(allowlist_path, 1, "lock-allowlist",
                                    f"{where}: not an object"))
            continue
        kind = e.get("kind")
        if kind not in ALLOWLIST_KINDS:
            findings.append(Finding(
                allowlist_path, 1, "lock-allowlist",
                f"{where}: kind must be one of {ALLOWLIST_KINDS}, "
                f"got {kind!r}"))
        sites = e.get("sites")
        if not (isinstance(sites, list) and sites
                and all(isinstance(s, str) for s in sites)):
            findings.append(Finding(
                allowlist_path, 1, "lock-allowlist",
                f"{where}: sites must be a non-empty list of strings"))
            sites = []
        for s in sites:
            if lock_sites and s not in lock_sites:
                findings.append(Finding(
                    allowlist_path, 1, "lock-allowlist",
                    f"{where}: unknown lock/blocking site {s!r} — not "
                    f"constructed anywhere in the linted tree (stale "
                    f"entry after a rename?)"))
        just = e.get("justification", "")
        if not isinstance(just, str) or len(just.strip()) < 20:
            findings.append(Finding(
                allowlist_path, 1, "lock-allowlist",
                f"{where}: justification must explain WHY the finding "
                f"is safe (>= 20 chars), got {just!r}"))


# ------------------------------------------------------------- entry point

def run_lint(paths: Sequence[str],
             doc_catalog_path: Optional[str] = None,
             allowlist_path: Optional[str] = None) -> List[Finding]:
    """Lint ``paths`` (files or directories).  ``doc_catalog_path``
    defaults to ``<repo>/docs/observability.md`` found by walking up
    from the first path; ``allowlist_path`` defaults to the in-package
    ``lockwitness_allowlist.json``.  Returns pragma-filtered findings
    sorted by (path, line)."""
    files = collect_files(paths)
    indexes: List[FileIndex] = []
    findings: List[Finding] = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(Finding(path, e.lineno or 1, "parse",
                                    f"syntax error: {e.msg}"))
            continue
        indexes.append(FileIndex(path, tree, src))

    known_sites = collect_registered_fault_sites(indexes)
    lock_sites = collect_lock_sites(indexes)

    root = _find_repo_root(paths)
    if doc_catalog_path is None and root is not None:
        cand = os.path.join(root, "docs", "observability.md")
        doc_catalog_path = cand if os.path.exists(cand) else None
    catalog = _doc_catalog(doc_catalog_path)
    span_catalog = _doc_span_catalog(doc_catalog_path)

    if allowlist_path is None:
        from .lockwitness import DEFAULT_ALLOWLIST_PATH
        allowlist_path = DEFAULT_ALLOWLIST_PATH
    check_allowlist(allowlist_path, lock_sites, findings)

    for idx in indexes:
        per_file: List[Finding] = []
        _check_fault_sites(idx, known_sites, per_file)
        _check_metric_names(idx, catalog, per_file)
        _check_span_names(idx, span_catalog, per_file)
        _check_typed_raises(idx, per_file)
        _check_naked_acquire(idx, per_file)
        _check_wall_clock(idx, per_file)
        _check_raceguard(idx, per_file)
        for f in per_file:
            disabled = idx.pragmas.get(f.line, set())
            if f.rule in disabled or "all" in disabled:
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
