"""DLK006 refcount-pairing.

``PagePool.alloc``/``retain`` bump a block's refcount; a handle that is
dropped (or abandoned on an early exit) leaks the block until the pool
is torn down — under memory pressure that shows up as spurious
admission-control rejections, not a crash, so it survives testing. The
rule is lexical: an alloc result must be *consumed* (stored, passed,
returned, or freed), and no plain return/raise may sit between the
alloc and its first consumption — except under the ``if blk is None``
failure guard, where there is nothing to release.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       qualname, register)

_POOLISH = ("pool", "page")


def _pool_receiver(func) -> Optional[str]:
    """Receiver text if this is ``<pool>.alloc``/``<pool>.retain`` on
    something pool-shaped. ``self.alloc`` (the pool's own implementation)
    is exempt — pairing inside the pool is the pool's invariant, checked
    by its tests, not by call-site lint."""
    if not isinstance(func, ast.Attribute):
        return None
    recv = qualname(func.value)
    if not recv or recv == "self":
        return None
    probe = recv[5:] if recv.startswith("self.") else recv
    if any(p in probe.lower() for p in _POOLISH):
        return recv
    return None


def _is_none_guard(test, name: str) -> bool:
    """``blk is None`` anywhere in the test (possibly or-joined)."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Compare) \
                and isinstance(sub.left, ast.Name) and sub.left.id == name \
                and any(isinstance(op, ast.Is) for op in sub.ops) \
                and any(isinstance(c, ast.Constant) and c.value is None
                        for c in sub.comparators):
            return True
    return False


@register
class RefcountPairing(Rule):
    """Pool blocks acquired but not consumed/released on every path."""

    code = "DLK006"
    name = "refcount-pairing"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("alloc", "retain")):
                continue
            recv = _pool_receiver(node.func)
            if recv is None:
                continue
            parent = ctx.parent(node)

            # alloc whose result is dropped: refcount went up, handle gone
            if node.func.attr == "alloc" and isinstance(parent, ast.Expr):
                yield ctx.finding(
                    self, node,
                    f"result of {recv}.alloc() discarded — the block's "
                    "refcount was bumped but the handle is lost (leak)")
                continue
            if node.func.attr != "alloc":
                continue    # bare retain(expr) pairs with a stored handle
            if not isinstance(parent, ast.Assign):
                continue    # alloc feeding a call/return is consumed inline
            tgt = parent.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            name = tgt.id
            fn = ctx.enclosing_function(node)
            scope = fn if fn is not None else ctx.tree

            # first later *use* of the handle (free()/store/pass/return all
            # count — any of them either releases or transfers ownership)
            uses = sorted(n.lineno for n in ast.walk(scope)
                          if isinstance(n, ast.Name) and n.id == name
                          and isinstance(n.ctx, ast.Load)
                          and n.lineno > parent.lineno)
            if not uses:
                yield ctx.finding(
                    self, node,
                    f"'{name}' = {recv}.alloc() is never used afterwards — "
                    "acquired block is neither stored nor released")
                continue
            first_use = uses[0]
            for exit_ in ast.walk(scope):
                if not isinstance(exit_, (ast.Return, ast.Raise)):
                    continue
                if not parent.lineno < exit_.lineno < first_use:
                    continue
                guarded = any(
                    isinstance(anc, ast.If) and _is_none_guard(anc.test, name)
                    for anc in ctx.ancestors(exit_))
                if guarded:
                    continue    # alloc failed; nothing to release
                kind = "return" if isinstance(exit_, ast.Return) else "raise"
                yield ctx.finding(
                    self, exit_,
                    f"{kind} between '{name} = {recv}.alloc()' (line "
                    f"{parent.lineno}) and its first use — the block "
                    "leaks on this path")
