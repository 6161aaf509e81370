"""Checked-in finding baseline.

A baseline lets the linter land with pre-existing findings grandfathered:
entries are keyed on ``(code, path, stripped source line)`` so they
survive line-number churn but die with the offending code. The file is
JSON, sorted, and deterministic — regenerating it on an unchanged tree
is a no-op, which is itself under test.

Policy: DLK001, DLK008, DLK009 and DLK010 findings are *fixed*, never
baselined — an uncounted compile or capture, a leaked slot state, a
per-iteration host sync, or a signature-changing dtype drift is always a
bug, not a style call. The shipped baseline is empty, and the
``test_checked_in_baseline_has_no_*`` tests keep it honest.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Set, Tuple

from repro_torch.analysis.core import Finding

#: the checked-in baseline, package-local
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

Key = Tuple[str, str, str]


def load(path=DEFAULT_BASELINE) -> Set[Key]:
    path = Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {(e["code"], e["path"], e["line_text"])
            for e in data.get("findings", [])}


def save(findings: Iterable[Finding], path=DEFAULT_BASELINE) -> Dict:
    """Write the non-suppressed findings as the new baseline. Sorted and
    key-deduplicated so the output is byte-stable for a given tree."""
    keys = sorted({f.key() for f in findings if not f.suppressed})
    doc = {
        "comment": "dalek-lint baseline — regenerate with "
                   "`python -m repro_torch.analysis --write-baseline <paths>`",
        "counts": _counts(keys),
        "findings": [{"code": c, "path": p, "line_text": t}
                     for c, p, t in keys],
    }
    Path(path).write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return doc


def _counts(keys: Iterable[Key]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for code, _, _ in keys:
        out[code] = out.get(code, 0) + 1
    return dict(sorted(out.items()))


def apply(findings: List[Finding], baseline: Set[Key]) -> List[Finding]:
    """Mark findings present in the baseline; returns the same list."""
    for f in findings:
        if not f.suppressed and f.key() in baseline:
            f.baselined = True
    return findings
