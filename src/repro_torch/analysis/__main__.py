"""Static contract gate: lint the port against its standing invariants.

    PYTHONPATH=src python -m repro_torch.analysis

Exit 0 when every error-severity finding is suppressed with a
justification; non-zero otherwise.  ``--json`` emits the full machine-
readable report, ``--baseline FILE`` grandfathers a previous report's
findings (adopting the gate on a tree with known debt), and
``--update-wire-lock`` regenerates the port's ``wire_schema.lock.json``
from the current codec/framing source after a reviewed wire change.

The flags, the verdict line and the exit codes are those of the
reference's gate, ``python -m benchmarks.check_contracts``.  Rules,
suppression syntax (``# repro: allow[RULE-ID] <why>``), and how to add a
rule: ``README.md`` in this package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch import analysis
from repro_torch.analysis.rules import wire_drift


def _update_wire_lock(root: Optional[str]) -> int:
    root = os.path.abspath(root or analysis.repo_root())
    modules = analysis.core.collect_modules(root, analysis.DEFAULT_PATHS)
    project = analysis.Project(root, modules)
    schema, _ = wire_drift.extract_schema(project)
    path = wire_drift.write_lock(root, schema)
    print(f"wire schema lock written: {path}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based gate for the port's standing contracts")
    ap.add_argument("--root", default=None,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="ID",
                    help="run only this rule id (repeatable)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="JSON report whose findings are grandfathered")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report on stdout")
    ap.add_argument("--update-wire-lock", action="store_true",
                    help="regenerate wire_schema.lock.json from source "
                         "after a reviewed wire change")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the verdict")
    args = ap.parse_args(argv)

    if args.update_wire_lock:
        return _update_wire_lock(args.root)

    report = analysis.run_checks(
        root=args.root, rules=args.rules, baseline=args.baseline)
    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    elif not args.quiet:
        rendered = report.render(verbose=False)
        if rendered:
            print(rendered)

    n_err = len(report.errors)
    n_warn = len(report.unsuppressed(analysis.WARNING))
    n_supp = sum(1 for f in report.findings if f.suppressed)
    verdict = "PASS" if report.ok else "FAIL"
    line = (f"check_contracts: {verdict} — {n_err} error(s), "
            f"{n_warn} warning(s), {n_supp} suppressed")
    if report.ok:
        if not args.json:
            print(line)
        return 0
    print(f"FAIL: {line}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
