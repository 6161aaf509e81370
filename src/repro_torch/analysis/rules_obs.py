"""DLK007 unclosed-span.

A :class:`repro_torch.obs.spans.Span` that is opened but never ended is
invisible in the exported timeline (``Tracer.spans()`` only returns
finished spans) and silently breaks the energy partition: the sample
window its compute landed in ends up attributed to no span at all. The
discipline is lexical:

* ``tracer.span(...)`` is the lexical form — its result must be entered
  with ``with`` (directly, or via a named handle), never discarded;
* ``h = tracer.begin(...)`` is the non-lexical form — some path must call
  ``h.end(...)`` (or enter ``h`` with ``with``).

The rule is receiver-shaped (anything whose dotted name contains
"tracer") and deliberately conservative: name handles must close inside
their enclosing function, attribute handles (``self._sp = ...``) anywhere
in the module (another method may own the close); handles stored
into containers (subscript targets), returned, or passed to calls transfer
ownership and are skipped.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       qualname, register)


def _tracer_receiver(func) -> Optional[str]:
    """Receiver text for ``<tracer>.span``/``<tracer>.begin`` calls on
    something tracer-shaped (``self.tracer``, ``tracer``, ``req_tracer``)."""
    if not isinstance(func, ast.Attribute):
        return None
    recv = qualname(func.value)
    if not recv or recv == "self":
        return None
    if "tracer" in recv.lower():
        return recv
    return None


def _in_with_item(ctx: ModuleContext, call: ast.Call) -> bool:
    """Is the call (a descendant of) some ``with`` item's context expr?"""
    for anc in ctx.ancestors(call):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                if item.context_expr is call or any(
                        n is call for n in ast.walk(item.context_expr)):
                    return True
    return False


def _name_entered_or_ended(tree, name: str, after_line: int) -> bool:
    """Does ``name`` later flow into a ``with`` or a ``.end(`` call?"""
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Name) and sub.id == name:
                        return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "end":
            base = node.func.value
            if isinstance(base, ast.Name) and base.id == name:
                return True
    return False


def _attr_ended(tree, attr: str) -> bool:
    """``<anything>.<attr>.end(`` anywhere in the module (handle stored on
    an object; any method may close it)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "end":
            base = node.func.value
            if isinstance(base, ast.Attribute) and base.attr == attr:
                return True
    return False


@register
class UnclosedSpan(Rule):
    """Tracer span opened outside ``with`` and never ended on any path."""

    code = "DLK007"
    name = "unclosed-span"
    skip_tests = True      # tests open dangling spans to probe the tracer

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "begin")):
                continue
            recv = _tracer_receiver(node.func)
            if recv is None:
                continue
            if _in_with_item(ctx, node):
                continue                 # `with tracer.span(...)`: closed
            parent = ctx.parent(node)

            # result discarded outright: the span can never be ended
            if isinstance(parent, ast.Expr):
                yield ctx.finding(
                    self, node,
                    f"result of {recv}.{node.func.attr}() discarded — the "
                    "span is never ended and will not appear in the "
                    "exported timeline")
                continue

            # walk up through value wrappers (ternary, boolop) to the
            # binding statement; non-Assign consumers (return / call arg /
            # comprehension) transfer ownership and are skipped
            stmt = parent
            while stmt is not None and not isinstance(stmt, ast.stmt):
                stmt = ctx.parent(stmt)
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            tgt = stmt.targets[0]
            fn = ctx.enclosing_function(node)
            scope = fn if fn is not None else ctx.tree
            if isinstance(tgt, ast.Name):
                if not _name_entered_or_ended(scope, tgt.id, stmt.lineno):
                    yield ctx.finding(
                        self, node,
                        f"'{tgt.id}' = {recv}.{node.func.attr}() is never "
                        "entered with 'with' nor ended with "
                        f"'{tgt.id}.end()' — unclosed span")
            elif isinstance(tgt, ast.Attribute):
                if not _attr_ended(ctx.tree, tgt.attr):
                    yield ctx.finding(
                        self, node,
                        f"'{qualname(tgt)}' = {recv}.{node.func.attr}() has "
                        f"no matching '.{tgt.attr}.end()' in this module — "
                        "unclosed span")
            # Subscript / Tuple targets: stored into a collection, ownership
            # transferred (e.g. an engine's req_id -> span map)
