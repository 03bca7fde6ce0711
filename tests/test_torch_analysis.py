"""The port's static analysis (``mxnet_tpu_torch.analysis.lint`` and
``raceguard``) against the reference's.

Every fixture tree of ``tests/test_analysis.py`` (one per lint rule)
and ``tests/test_raceguard.py`` (its guarded-by, declaration, pragma,
callback and guard-map fixtures) is written twice: under
``mxnet_tpu/<component>/`` for the reference's linter and under
``mxnet_tpu_torch/<component>/`` for the port's.  Both give the same
findings (path relative to the package directory, line, rule, message)
and the same guard map apart from ``generated_by``.  The port itself
lints clean within the reference's 5 s budget, its checked-in
concurrency contract regenerates byte for byte, and
``tools/mxlint_torch.py`` keeps ``tools/mxlint.py``'s exit codes and
SARIF round trip.
"""
import json
import os
import sys
import time

import pytest

from mxnet_tpu.analysis import lint as jlint
from mxnet_tpu.analysis import raceguard as jrg
from mxnet_tpu_torch.analysis import lint as tlint
from mxnet_tpu_torch.analysis import raceguard as trg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")
CATALOG = os.path.join(REPO, "docs", "observability.md")
CONTRACT = os.path.join(PKG, "analysis", "concurrency_contract.json")

H = ("from mxnet_tpu.analysis.lockwitness import named_lock, "
     "named_rlock, named_condition\n")


def _cls(site, body, init=""):
    """A class with one named lock ``self._lock`` at ``site``."""
    return H + ("class C:\n"
                "    def __init__(self):\n"
                f"        self._lock = named_lock('{site}')\n"
                + init + body)


# name: ({path under the package dir ('{pkg}' = its name): source},
#        catalog markdown or None, allowlist JSON or None)
TREES = {
    "fault_site": ({"serving/fix.py": (
        "from mxnet_tpu.resilience.faults import inject, register_site\n"
        "register_site('fixture.good')\n"
        "inject('fixture.good')\n"
        "inject('fixture.good@replica-1')\n"
        "inject('fixture.typo')\n"
        "FaultPlan().kill_at('fixture.unseen', at=1)\n")}, None, None),
    "metric_name": ({"serving/fix.py": (
        "A = 'mxtpu_fixture_documented'\n"
        "B = 'mxtpu_fixture_anything_total'\n"
        "C = 'mxtpu_fixture_'\n"
        "D = 'mxtpu-fixture-thread'\n"
        "E = 'mxtpu_Fixture_Bad'\n"
        "F = 'mxtpu_fixture_undocumented'\n")},
        "| `mxtpu_fixture_documented` | gauge |\n"
        "| `mxtpu_fixture_<counter>_total` | counter |\n", None),
    "span_name": ({"serving/fix.py": (
        "def f(tr, fr, name):\n"
        "    tr.event('serving.documented')\n"
        "    fr.record('fleet.known_event', x=1)\n"
        "    tr.span(name)\n"
        "    tr.event('checkpoint.fallback')\n"
        "    tr.event('chaos.probe')\n"
        "    fr.record('prefill')\n"
        "    tr.event('serving.undocumented')\n"
        "    fr.trigger('fleet.unheard_of')\n"
        "    tr.record_span('loop.mystery', 0, 1)\n"),
        "other/fix.py": (
        "from mxnet_tpu.resilience.faults import inject, register_site\n"
        "register_site('serving.fixture_site')\n"
        "inject('serving.fixture_site')\n")},
        "| `serving.documented` | per request | ... |\n"
        "| `fleet.known_event` | attrs | ... |\n", None),
    "typed_raise": ({name: (
        "from mxnet_tpu.base import MXNetError\n"
        "class GoodError(MXNetError):\n    pass\n"
        "def f(x):\n"
        "    if x == 1:\n        raise ValueError('untyped')\n"
        "    if x == 2:\n        raise RuntimeError('untyped')\n"
        "    raise GoodError('typed is fine')\n")
        for name in ("fleet/fix.py", "gluon/fix.py",
                     "{pkg}/{pkg}/serving/fix.py")}, None, None),
    "naked_acquire": ({"serving/fix.py": (
        "import threading\n"
        "L = threading.Lock()\n"
        "def good():\n"
        "    with L:\n        pass\n"
        "    got = L.acquire(timeout=1.0)\n"
        "    try:\n        pass\n"
        "    finally:\n"
        "        if got:\n            L.release()\n"
        "def bad():\n"
        "    L.acquire()\n"
        "    L.release()\n")}, None, None),
    "wall_clock": ({name: (
        "import time\n"
        "def f():\n"
        "    t0 = time.time()\n"
        "    t1 = time.time()  # mxlint: disable=wall-clock\n"
        "    return time.monotonic() - t0 + t1\n")
        for name in ("resilience/fix.py", "gluon/fix.py")}, None, None),
    "lock_allowlist_ok": ({"serving/locks.py": (
        "from mxnet_tpu.analysis.lockwitness import named_lock\n"
        "L = named_lock('fixture.lock_a')\n")}, None,
        '{"entries": [{"kind": "blocking", "sites": ["fixture.lock_a"], '
        '"justification": "held only for a bounded in-memory append"}]}'),
    "lock_allowlist_bad": ({"serving/locks.py": (
        "from mxnet_tpu.analysis.lockwitness import named_lock\n"
        "L = named_lock('fixture.lock_a')\n")}, None,
        '{"entries": [{"kind": "nonsense", "sites": ["fixture.renamed"], '
        '"justification": "no"}]}'),
    "rg_basic": ({"serving/fix.py": _cls("fixture.rg_basic", (
        "    def good(self):\n"
        "        with self._lock:\n"
        "            self.count += 1\n"
        "    def bad_write(self):\n"
        "        self.count = 5\n"
        "    def bad_read(self):\n"
        "        return self.count\n"), "        self.count = 0\n")},
        None, None),
    "rg_publish": ({"serving/fix.py": _cls("fixture.rg_pub", (
        "    def locked(self):\n"
        "        with self._lock:\n"
        "            self.count = 1\n"
        "    def read_published(self):\n"
        "        return self.mode\n"),
        "        self.mode = 'decode'\n        self.count = 0\n")},
        None, None),
    "rg_subscript": ({"serving/fix.py": _cls("fixture.rg_sub", (
        "    def locked(self, k, v):\n"
        "        with self._lock:\n"
        "            self.d[k] = v\n"
        "    def bad(self, k, v):\n"
        "        self.d[k] = v\n"), "        self.d = {}\n")}, None, None),
    "rg_rlock_cond": ({"serving/fix.py": H + (
        "class C:\n"
        "    def __init__(self):\n"
        "        self._r = named_rlock('fixture.rg_rl')\n"
        "        self._cond = named_condition('fixture.rg_cv')\n"
        "        self.a = self.b = 0\n"
        "    def reentrant(self):\n"
        "        with self._r:\n"
        "            self.a = 1\n"
        "            with self._r:\n"
        "                self.a = 2\n"
        "    def waits(self):\n"
        "        with self._cond:\n"
        "            self.b = 1\n"
        "            self._cond.wait(0.01)\n")}, None, None),
    "rg_bounded_acquire": ({"serving/fix.py": _cls("fixture.rg_ba", (
        "    def locked(self):\n"
        "        with self._lock:\n"
        "            self.n = 1\n"
        "    def bounded(self):\n"
        "        got = self._lock.acquire(timeout=1.0)\n"
        "        try:\n"
        "            self.n = 2\n"
        "        finally:\n"
        "            if got:\n"
        "                self._lock.release()\n"), "        self.n = 0\n")},
        None, None),
    "rg_nested_function": ({"serving/fix.py": _cls("fixture.rg_nf", (
        "    def locked(self):\n"
        "        with self._lock:\n"
        "            self.n = 1\n"
        "            def later():\n"
        "                return self.n\n"
        "            return later\n"), "        self.n = 0\n")}, None, None),
    "rg_match": ({"serving/fix.py": _cls("fixture.rg_match", (
        "    def locked(self, v):\n"
        "        match v:\n"
        "            case 1:\n"
        "                with self._lock:\n"
        "                    self.n = 1\n"
        "            case _:\n"
        "                got = self._lock.acquire(timeout=1.0)\n"
        "                try:\n"
        "                    self.n = 2\n"
        "                finally:\n"
        "                    if got:\n"
        "                        self._lock.release()\n"
        "    def bad(self, v):\n"
        "        match v:\n"
        "            case 1:\n"
        "                self.n = 3\n"), "        self.n = 0\n")},
        None, None),
    "rg_declaration": ({"serving/fix.py": _cls("fixture.rg_dec", (
        "    def bad(self):\n"
        "        return self.boxed\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            return self.boxed\n"),
        "        self.boxed = []  # guarded-by: _lock\n")}, None, None),
    "rg_caller_holds": ({"serving/fix.py": _cls("fixture.rg_ch", (
        "    def outer(self):\n"
        "        with self._lock:\n"
        "            self.n += 1\n"
        "            self._helper()\n"
        "    def _helper(self):  # guarded-by: _lock\n"
        "        self.n += 1\n"), "        self.n = 0\n")}, None, None),
    "rg_unknown_guard_orphan": ({"serving/fix.py": _cls("fixture.rg_uk", (
        "# guarded-by: _floating\n"
        "class D:\n"
        "    pass\n"), "        self.x = 0  # guarded-by: _nonesuch\n")},
        None, None),
    "rg_pragma": ({"serving/fix.py": _cls("fixture.rg_pr", (
        "    def locked(self):\n"
        "        with self._lock:\n"
        "            self.flag = True\n"
        "    def probe(self):\n"
        "        return self.flag  # raceguard: unguarded(atomic bool "
        "read on a health probe, staleness is harmless)\n"
        "    def short(self):\n"
        "        return self.flag  # raceguard: unguarded(meh)\n"),
        "        self.flag = False\n")}, None, None),
    "rg_pragma_verbs": ({"serving/fix.py": _cls("fixture.rg_uv", (
        "    def f(self):\n"
        "        return '# raceguard: unguarded(not a real pragma)'\n"
        "    def g(self):\n"
        "        x = 1  # raceguard: blessed(this verb does not exist)\n"
        "        return x\n"))}, None, None),
    "rg_callbacks": ({"serving/fix.py": _cls("fixture.rg_cb", (
        "    def bad(self, fut, exc):\n"
        "        with self._lock:\n"
        "            self.waiters.append(fut)\n"
        "            fut.set_exception(exc)\n"
        "    def good(self, fut, value):\n"
        "        with self._lock:\n"
        "            self.waiters.remove(fut)\n"
        "        fut.set_result(value)\n"
        "    def user(self):\n"
        "        with self._lock:\n"
        "            self.cb()\n"
        "    def blessed(self):\n"
        "        with self._lock:\n"
        "            self.cb()  # raceguard: callback-ok(the callback "
        "is a bound counter increment owned by this class)\n"),
        "        self.waiters = []\n")}, None, None),
    "rg_guard_map": ({"serving/mod.py": H + (
        "GLOBAL_LOCK = named_lock('fixture.map_mod')\n"
        "_STATE = {}\n"
        "def swap(k, v):\n"
        "    with GLOBAL_LOCK:\n"
        "        _STATE[k] = v\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = named_lock('fixture.map_cls')\n"
        "        self.n = 0\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self.n += 1\n")}, None, None),
    "rg_sarif_fixture": ({"fleet/x.py": _cls("fixture.sarif", (
        "    def locked(self):\n"
        "        with self._lock:\n"
        "            self.n = 1\n"
        "    def bad(self):\n"
        "        return self.n\n"
        "def f():\n    raise ValueError('x')\n"), "        self.n = 0\n")},
        None, None),
}


def _write(base, pkg, files, catalog, allow):
    root = base / pkg
    for rel, src in files.items():
        p = root / rel.format(pkg=pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src, encoding="utf-8")
    cat = None
    if catalog is not None:
        cat = base / "catalog.md"
        cat.write_text(catalog)
    al = base / "allow.json"
    if allow is not None:
        al.write_text(allow)
    return str(root), (str(cat) if cat else None), str(al)


def _findings(run_lint, root, cat, al):
    """(path relative to the package dir, its package-named directories
    as '{pkg}', line, rule, message) of each finding."""
    pkg = os.path.basename(root)
    return sorted(("/".join("{pkg}" if part == pkg else part for part in
                            os.path.relpath(f.path, root).split(os.sep)),
                   f.line, f.rule, f.message)
                  for f in run_lint([root], doc_catalog_path=cat,
                                    allowlist_path=al))


@pytest.mark.parametrize("tree", sorted(TREES))
def test_fixture_tree_findings_and_guard_map_equal_the_reference(
        tmp_path, tree):
    files, catalog, allow = TREES[tree]
    jroot, jcat, jal = _write(tmp_path / "ref", "mxnet_tpu", files,
                              catalog, allow)
    troot, tcat, tal = _write(tmp_path / "port", "mxnet_tpu_torch", files,
                              catalog, allow)
    want = _findings(jlint.run_lint, jroot, jcat, jal)
    got = _findings(tlint.run_lint, troot, tcat, tal)
    assert got == want
    jmap = jrg.build_guard_map([jroot], root=jroot)
    tmap = trg.build_guard_map([troot], root=troot)
    assert jmap.pop("generated_by").startswith("mxnet_tpu.")
    assert tmap.pop("generated_by") == \
        "mxnet_tpu_torch.analysis.raceguard.build_guard_map"
    assert tmap == jmap


def test_component_keys_on_the_port_package():
    """The segment after the LAST ``mxnet_tpu_torch`` element, so a
    checkout directory of that name does not shadow the package; a
    fixture tree's component is the parent directory."""
    c = tlint._component
    assert c(os.path.join("x", "mxnet_tpu_torch", "mxnet_tpu_torch",
                          "serving", "engine.py")) == "serving"
    assert c(os.path.join("mxnet_tpu_torch", "fleet", "router.py")) == "fleet"
    assert c(os.path.join("mxnet_tpu_torch", "random.py")) is None
    assert c(os.path.join("tmp", "mxnet_tpu", "data", "x.py")) == "data"


def test_port_is_lint_clean_within_budget():
    t0 = time.perf_counter()
    findings = tlint.run_lint([PKG])
    elapsed = time.perf_counter() - t0
    assert findings == [], "\n".join(repr(f) for f in findings)
    assert elapsed < 5.0, f"run_lint({PKG}) took {elapsed:.2f}s"


def test_checked_in_concurrency_contract_is_fresh():
    """Regenerating the port's contract is a byte-identical no-op
    (``python tools/mxlint_torch.py --guard-map
    mxnet_tpu_torch/analysis/concurrency_contract.json``)."""
    gmap = trg.build_guard_map([PKG], root=REPO)
    want = json.dumps(gmap, indent=2, sort_keys=True) + "\n"
    with open(CONTRACT, encoding="utf-8") as f:
        assert f.read() == want, "concurrency_contract.json is stale"
    for site, why in trg.CORROBORATION_EXEMPT.items():
        assert site in gmap["sites"], site
        assert len(why.strip()) >= 20, site
    assert trg.corroboration_exempt("cuda") == {}
    assert trg.corroboration_exempt("cpu") == trg.CORROBORATION_EXEMPT


def test_analysis_exports_load_lazily():
    import mxnet_tpu_torch.analysis as an
    assert an.run_lint is tlint.run_lint and an.RULES is tlint.RULES
    assert an.build_guard_map is trg.build_guard_map
    assert an.raceguard is trg and an.Finding is tlint.Finding
    assert an.corroborate is trg.corroborate
    assert set(tlint.RULES) == set(jlint.RULES)


def _mxlint():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import mxlint_torch
    finally:
        sys.path.pop(0)
    return mxlint_torch


def test_cli_exit_codes_and_sarif_round_trip(tmp_path):
    cli = _mxlint()
    files, _cat, _allow = TREES["rg_sarif_fixture"]
    root, _c, no_allow = _write(tmp_path, "mxnet_tpu_torch", files, None,
                                None)
    out = tmp_path / "report.json"
    assert cli.main([root, "--json", str(out), "--allowlist",
                     no_allow]) == 1
    rep = json.loads(out.read_text())
    assert rep["count"] == 2
    assert cli.main([str(tmp_path / "missing")]) == 2
    assert cli.main(["--list-rules"]) == 0
    sarif = tmp_path / "report.sarif"
    assert cli.main([root, "--sarif", str(sarif), "--allowlist",
                     no_allow]) == 1
    log = json.loads(sarif.read_text())
    assert log["version"] == "2.1.0" and len(log["runs"]) == 1
    got = cli.from_sarif(log, cli._REPO)
    want = [(f.rule, os.path.normpath(f.path), f.line, f.message)
            for f in tlint.run_lint([root], allowlist_path=no_allow)]
    assert sorted(got) == sorted(want)
    assert {r for r, *_ in got} == {"typed-raise", "guarded-by"}
    clean = tmp_path / "clean" / "serving"
    clean.mkdir(parents=True)
    (clean / "y.py").write_text("x = 1\n")
    out2 = tmp_path / "clean.sarif"
    assert cli.main([str(tmp_path / "clean"), "--sarif", str(out2),
                     "--allowlist", no_allow]) == 0
    assert json.loads(out2.read_text())["runs"][0]["results"] == []
    gm = tmp_path / "map.json"
    assert cli.main([PKG, "--guard-map", str(gm)]) == 0
    assert "serving.engine.step" in json.loads(gm.read_text())["sites"]
