"""dalek-lint command line.

    PYTHONPATH=src python -m repro_torch.analysis [opts] [paths...]

Run from the repo root: with no paths it lints the port
(``src/repro_torch``, ``chip_smoke.py``, ``tests/test_torch_*.py``,
``tests/torch_dist_worker.py``). Exit status is 1 iff any *active* finding
remains (not pragma-suppressed, not baselined when --baseline is given).
``--gate-json`` writes rows the port's regression gate
(``repro_torch.benchmarks.regression_gate``) reads: any increase in a
row's ``findings`` count across runs fails it.
"""
from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import Dict, List

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.core import (Finding, all_rules, analyze_paths,
                                       rule_codes)
from repro_torch.analysis.project import analyze_project

DEFAULT_PATHS = ["src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py",
                 "tests/torch_dist_worker.py"]


def default_paths(root: str = ".") -> List[str]:
    """``DEFAULT_PATHS`` under ``root``, globs expanded (sorted)."""
    out: List[str] = []
    for pat in DEFAULT_PATHS:
        out.extend(sorted(glob.glob(f"{root}/{pat}")))
    return out


def _summary(findings: List[Finding]) -> Dict[str, int]:
    out = {"total": 0, "active": 0, "suppressed": 0, "baselined": 0}
    for f in findings:
        out["total"] += 1
        if f.suppressed:
            out["suppressed"] += 1
        elif f.baselined:
            out["baselined"] += 1
        else:
            out["active"] += 1
    return out


def gate_rows(findings: List[Finding]) -> Dict[str, Dict[str, int]]:
    """Zero-filled per-rule rows + a total, in regression-gate row shape.
    Zero rows matter: a rule that has never fired still produces a row, so
    its first firing is an *increase* on an existing row, which gates."""
    rows = {f"analysis/{code}": {"findings": 0} for code in rule_codes()}
    rows["analysis/total"] = {"findings": 0}
    for f in findings:
        if not f.active:
            continue
        rows[f"analysis/{f.code}"]["findings"] += 1
        rows["analysis/total"]["findings"] += 1
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="dalek-lint for the port: AST checks for the repo's "
                    "step/energy/paging discipline")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--project", action="append", nargs="?", const="",
                    default=None, metavar="DIR", help="whole-program mode: "
                    "build one ProjectIndex over DIR (repeatable; positional "
                    "paths join the same project; with no DIR and no paths, "
                    "the default paths) so interprocedural rules resolve "
                    "calls across modules")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE", help="only these rules (code or slug, "
                    "comma-separable, repeatable)")
    ap.add_argument("--ignore", action="append", default=None,
                    metavar="RULE", help="drop these rules")
    ap.add_argument("--baseline", action="store_true",
                    help="tolerate findings recorded in the baseline file")
    ap.add_argument("--baseline-file", default=None,
                    help="baseline path (default: packaged baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current non-suppressed findings as the "
                    "baseline and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    ap.add_argument("--gate-json", default=None, metavar="FILE",
                    help="write per-rule finding counts as regression-gate "
                    "bench rows")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed/baselined findings")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(all_rules(), key=lambda r: r.code):
            doc = (rule.__doc__ or "").strip().splitlines()[0]
            print(f"{rule.code}  {rule.name:18s} {doc}")
        return 0

    def split(vals):
        return [tok for v in vals or () for tok in v.split(",") if tok]

    if args.project:
        roots = [p for p in args.project if p] + (args.paths or [])
        findings = analyze_project(roots or default_paths(),
                                   select=split(args.select),
                                   ignore=split(args.ignore))
    else:
        paths = args.paths or default_paths()
        findings = analyze_paths(paths, select=split(args.select),
                                 ignore=split(args.ignore))

    bl_path = args.baseline_file or baseline_mod.DEFAULT_BASELINE
    if args.write_baseline:
        doc = baseline_mod.save(findings, bl_path)
        print(f"wrote {len(doc['findings'])} baseline entries to {bl_path}")
        return 0
    if args.baseline:
        baseline_mod.apply(findings, baseline_mod.load(bl_path))

    summary = _summary(findings)
    if args.as_json:
        print(json.dumps({"summary": summary,
                          "findings": [f.as_dict() for f in findings]},
                         indent=2))
    else:
        for f in findings:
            if f.active or args.show_suppressed:
                print(f.render())
        if summary["total"]:
            print(f"-- {summary['active']} active, "
                  f"{summary['suppressed']} suppressed, "
                  f"{summary['baselined']} baselined "
                  f"({summary['total']} total)", file=sys.stderr)

    if args.gate_json:
        with open(args.gate_json, "w") as fh:
            json.dump(gate_rows(findings), fh, indent=2, sort_keys=True)

    return 1 if summary["active"] else 0


if __name__ == "__main__":
    sys.exit(main())
