"""DLK012 unguarded-shared-state.

Groundwork for the async intake thread (ROADMAP): once a second thread
feeds the engine, every class that already owns a ``threading.Lock`` is a
shared object — and a field that is written under ``with self._lock`` in
one method but read bare in another is a race waiting for that thread to
land (torn reads of dict iteration, lost increments).

The rule is class-local with project-wide call-site reasoning:

* a class is *lock-guarded* if it assigns ``threading.Lock()``/``RLock()``
  to ``self.<attr>`` **or** uses ``with self.<attr>`` where the attribute
  name contains "lock" (the lock may be created in a base class);
* an access ``self.<field>`` is *guarded* if an enclosing ``with
  self.<lock>`` covers it, or the enclosing method is itself
  guaranteed-guarded: its name ends in ``_locked``, or every call site
  ``<recv>.<meth>(...)`` in non-test modules sits under ``with
  <recv>.<lock>`` (or inside another guaranteed-guarded method) — computed
  to a fixpoint through :class:`~repro_torch.analysis.project.ProjectIndex`'s
  call-site table;
* a field is flagged when it has a write outside ``__init__``, at least
  one guarded access, and at least one bare access outside ``__init__`` —
  mixed discipline, the torn-read shape.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       qualname, register)

_LOCK_CTORS = {"Lock", "RLock"}


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Lock attributes this class owns or uses (``self.<attr>``)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            qn = qualname(node.value.func)
            if qn.rsplit(".", 1)[-1] in _LOCK_CTORS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        out.add(tgt.attr)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                qn = qualname(item.context_expr)
                if qn.startswith("self.") and qn.count(".") == 1 \
                        and "lock" in qn.lower():
                    out.add(qn.split(".", 1)[1])
    return out


def _methods(cls: ast.ClassDef) -> List[ast.FunctionDef]:
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


#: container methods that mutate the receiver in place — writing through
#: them races with bare reads just like rebinding the field does
_MUTATORS = {"append", "appendleft", "extend", "insert", "pop", "popleft",
             "popitem", "remove", "clear", "update", "setdefault", "add",
             "discard", "sort"}


def _is_write(ctx: ModuleContext, node: ast.Attribute) -> bool:
    """Store/Del of ``self.<field>``, an item store through it
    (``self._x[k] = v``), or an in-place mutator call (``self._x.append``)."""
    if isinstance(node.ctx, (ast.Store, ast.Del)):
        return True
    parent = ctx.parent(node)
    if isinstance(parent, ast.Subscript) and parent.value is node \
            and isinstance(parent.ctx, (ast.Store, ast.Del)):
        return True
    if isinstance(parent, ast.Attribute) and parent.value is node \
            and parent.attr in _MUTATORS:
        gp = ctx.parent(parent)
        if isinstance(gp, ast.Call) and gp.func is parent:
            return True
    return False


def _under_lock(ctx: ModuleContext, node, locks: Set[str],
                recv: str = "self") -> bool:
    """Is ``node`` inside ``with <recv>.<lock>`` for one of ``locks``?"""
    wanted = {f"{recv}.{la}" for la in locks}
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                if qualname(item.context_expr) in wanted:
                    return True
    return False


@register
class UnguardedSharedState(Rule):
    """Field accessed both under ``with self._lock`` and bare."""

    code = "DLK012"
    name = "unguarded-shared-state"
    skip_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls in ctx.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(cls)
            if not locks:
                continue
            yield from self._check_class(ctx, cls, locks)

    def _check_class(self, ctx, cls, locks) -> Iterator[Finding]:
        methods = _methods(cls)
        method_names = {m.name for m in methods}
        guarded_methods = self._guarded_methods(ctx, cls, methods, locks)

        # (field) -> [(node, method, guarded, is_write)]
        accesses: Dict[str, List[Tuple[ast.Attribute, str, bool, bool]]] = {}
        for meth in methods:
            for node in ast.walk(meth):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"):
                    continue
                field = node.attr
                if field in locks or field in method_names:
                    continue
                guarded = (_under_lock(ctx, node, locks)
                           or meth.name in guarded_methods)
                is_write = _is_write(ctx, node)
                accesses.setdefault(field, []).append(
                    (node, meth.name, guarded, is_write))

        for field in sorted(accesses):
            uses = accesses[field]
            written = any(w and m != "__init__" for _, m, _, w in uses)
            any_guarded = any(g for _, m, g, _ in uses if m != "__init__")
            if not (written and any_guarded):
                continue
            for node, meth_name, guarded, is_write in uses:
                if guarded or meth_name == "__init__":
                    continue
                verb = "written" if is_write else "read"
                yield ctx.finding(
                    self, node,
                    f"'self.{field}' is {verb} without the lock in "
                    f"'{cls.name}.{meth_name}' but accessed under "
                    f"'with self.{sorted(locks)[0]}' elsewhere — torn "
                    "read/lost update once a second thread touches this "
                    "object")

    @staticmethod
    def _guarded_methods(ctx, cls, methods, locks) -> Set[str]:
        """Methods that only ever run with the lock held: named
        ``*_locked``, or every project call site is under the lock (or in
        another guaranteed-guarded method) — a fixpoint over call sites."""
        proj = ctx.project
        guarded = {m.name for m in methods if m.name.endswith("_locked")}
        candidates = [m.name for m in methods
                      if not m.name.startswith("__")
                      and m.name not in guarded]
        changed = True
        while changed:
            changed = False
            for name in candidates:
                if name in guarded:
                    continue
                sites = proj.attr_calls.get(name, []) if proj is not None \
                    else []
                if not sites:
                    continue
                ok = True
                for sctx, call in sites:
                    recv = qualname(call.func.value)
                    if not recv:
                        ok = False
                        break
                    if _under_lock(sctx, call, locks, recv=recv):
                        continue
                    # a self-call from a method already known to hold
                    # the lock (same class only)
                    if recv == "self" and sctx is ctx:
                        encl = sctx.enclosing_function(call)
                        if encl is not None \
                                and sctx.enclosing_class(call) is cls \
                                and encl.name in guarded:
                            continue
                    ok = False
                    break
                if ok:
                    guarded.add(name)
                    changed = True
        return guarded
