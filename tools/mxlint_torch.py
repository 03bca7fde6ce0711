"""mxlint for the PyTorch port — run the port's project linter
(``mxnet_tpu_torch.analysis.lint``) over the tree; the counterpart of
``tools/mxlint.py``, with the same flags and exit codes.

The rules (docs/static_analysis.md) codify the project's contracts:
registered fault sites, documented mxtpu_* metrics and spans
(docs/observability.md), MXNetError-typed serving/fleet raises, `with`-scoped locks, the
monotonic-clock convention, a well-formed lockwitness allowlist, and
the raceguard guarded-by rules.

Usage::

    python tools/mxlint_torch.py [paths...]    # default: mxnet_tpu_torch/
    python tools/mxlint_torch.py --list-rules
    python tools/mxlint_torch.py --json report.json mxnet_tpu_torch/
    python tools/mxlint_torch.py --sarif report.sarif mxnet_tpu_torch/
    python tools/mxlint_torch.py --guard-map \\
        mxnet_tpu_torch/analysis/concurrency_contract.json

Exit code 0 when clean, 1 on any finding, 2 on usage errors — the
verify_checkpoint.py convention, so CI can distinguish "violations"
from "you pointed me at nothing".  ``--sarif`` writes the same
findings as a SARIF 2.1.0 log so CI hosts render them as inline line
annotations; it never changes the exit code.  ``--guard-map`` writes
the raceguard static concurrency contract (lock site → guarded
attributes — the file ``chaos_sweep_torch.py --corroborate`` diffs
against the runtime witness).  The linter is purely static (ast): it
imports neither torch nor the code it reads, and touches no device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings, rules, base: str) -> dict:
    """Findings → a minimal SARIF 2.1.0 log: one run, one driver, one
    result per finding with a physical location (relative URI + line).
    Lossless for (rule, path, line, message) — the round-trip test
    pins it."""
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "mxlint_torch",
                "informationUri":
                    "docs/static_analysis.md",
                "rules": [{"id": rule,
                           "shortDescription": {"text": desc}}
                          for rule, desc in sorted(rules.items())],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {
                        "uri": os.path.relpath(f.path, base).replace(
                            os.sep, "/")},
                    "region": {"startLine": f.line},
                }}],
            } for f in findings],
        }],
    }


def from_sarif(log: dict, base: str):
    """The inverse of :func:`to_sarif`: (rule, abs path, line, message)
    tuples — what the round-trip test compares against the findings."""
    out = []
    for run in log.get("runs", []):
        for res in run.get("results", []):
            loc = res["locations"][0]["physicalLocation"]
            out.append((res["ruleId"],
                        os.path.normpath(os.path.join(
                            base, loc["artifactLocation"]["uri"])),
                        loc["region"]["startLine"],
                        res["message"]["text"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="mxnet_tpu_torch project linter "
                    "(docs/static_analysis.md); "
                    "exit 1 on findings, 2 on usage errors")
    ap.add_argument("paths", nargs="*",
                    default=[os.path.join(_REPO, "mxnet_tpu_torch")],
                    help="files or directories to lint "
                         "(default: the mxnet_tpu_torch package)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write findings as a JSON report")
    ap.add_argument("--sarif", default=None, metavar="OUT",
                    help="also write findings as SARIF 2.1.0 (CI line "
                         "annotations); exit-code contract unchanged")
    ap.add_argument("--guard-map", default=None, metavar="OUT",
                    help="write the raceguard guard map (lock site -> "
                         "guarded attributes) for the linted paths and "
                         "exit 0 (plus 1 if there are lint findings)")
    ap.add_argument("--doc-catalog", default=None,
                    help="metric catalog markdown (default: "
                         "<repo>/docs/observability.md)")
    ap.add_argument("--allowlist", default=None,
                    help="lockwitness allowlist to validate (default: "
                         "mxnet_tpu_torch/analysis/"
                         "lockwitness_allowlist.json)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    from mxnet_tpu_torch.analysis.lint import RULES, run_lint

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:20s} {desc}")
        return 0

    for p in args.paths:
        if not os.path.exists(p):
            print(f"mxlint: no such path: {p!r}", file=sys.stderr)
            return 2

    if args.guard_map:
        from mxnet_tpu_torch.analysis.raceguard import build_guard_map
        gmap = build_guard_map(args.paths, root=_REPO)
        with open(args.guard_map, "w") as out:
            json.dump(gmap, out, indent=2, sort_keys=True)
            out.write("\n")
        print(f"mxlint: guard map ({len(gmap['sites'])} sites) -> "
              f"{args.guard_map}")

    findings = run_lint(args.paths, doc_catalog_path=args.doc_catalog,
                        allowlist_path=args.allowlist)
    for f in findings:
        print(f"{os.path.relpath(f.path)}:{f.line}: {f.rule}: {f.message}")
    if args.json:
        with open(args.json, "w") as out:
            json.dump({"findings": [f.as_dict() for f in findings],
                       "count": len(findings)}, out, indent=2)
    if args.sarif:
        with open(args.sarif, "w") as out:
            json.dump(to_sarif(findings, RULES, _REPO), out, indent=2)
            out.write("\n")
    if findings:
        print(f"mxlint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
