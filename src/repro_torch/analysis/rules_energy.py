"""DLK005 untagged-energy-region.

The paper's measurement discipline is tag-synchronized: every sampled
window is attributed to a GPIO region or an explicit tag list, otherwise
the joules land in the untagged bucket and per-phase attribution
(prefill vs decode vs checkpoint) silently loses mass. The rule tracks
names bound to ``MonitorSession(...)`` (and ``*session`` factory
results) and flags ``.sample(...)`` calls that carry no ``tags=`` and
sit under no ``with <session>.region(...)`` block.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       qualname, register)

_SESSIONY = ("session", "monitor")


def _callee_is_session_factory(call: ast.Call) -> bool:
    qn = qualname(call.func).lower()
    leaf = qn.rsplit(".", 1)[-1]
    return leaf == "monitorsession" or any(s in leaf for s in _SESSIONY)


def _session_names(ctx: ModuleContext) -> Set[str]:
    """Names/attrs bound to a monitor session in this module."""
    names: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _callee_is_session_factory(node.value):
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                many = len(elts) > 1
                for t in elts:
                    nm = t.id if isinstance(t, ast.Name) else \
                        t.attr if isinstance(t, ast.Attribute) else None
                    if nm is None:
                        continue
                    # tuple unpack: only the session-looking element is one
                    if many and not any(s in nm.lower() for s in _SESSIONY):
                        continue
                    names.add(nm)
        elif isinstance(node, ast.With):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call) \
                        and _callee_is_session_factory(item.context_expr) \
                        and isinstance(item.optional_vars, ast.Name):
                    names.add(item.optional_vars.id)
    return names


def _receiver_name(node: ast.Attribute) -> str:
    """'session' for session.sample, 'session' for self.session.sample."""
    val = node.value
    if isinstance(val, ast.Attribute):
        return val.attr
    if isinstance(val, ast.Name):
        return val.id
    return ""


@register
class UntaggedEnergyRegion(Rule):
    """``session.sample(...)`` with no ``tags=`` outside any
    ``with session.region(...)`` block: the window's joules become
    unattributable."""

    code = "DLK005"
    name = "untagged-energy"
    #: tests exercise the sampling mechanics themselves; their windows are
    #: synthetic and attribution is meaningless there
    skip_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        sessions = _session_names(ctx)
        if not sessions:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "sample"):
                continue
            recv = _receiver_name(node.func)
            if recv not in sessions:
                continue
            if any(kw.arg == "tags" for kw in node.keywords):
                continue
            # exempt when under `with <session>.region(...)` — the GPIO
            # tag is already high for this window
            in_region = False
            for anc in ctx.ancestors(node):
                if not isinstance(anc, ast.With):
                    continue
                for item in anc.items:
                    cexpr = item.context_expr
                    if isinstance(cexpr, ast.Call) \
                            and isinstance(cexpr.func, ast.Attribute) \
                            and cexpr.func.attr == "region" \
                            and _receiver_name(cexpr.func) in sessions:
                        in_region = True
            if in_region:
                continue
            yield ctx.finding(
                self, node,
                f"'{recv}.sample(...)' has no tags= and no enclosing "
                f"'with {recv}.region(...)': the window's energy is "
                "unattributable (lands in the untagged bucket)")
