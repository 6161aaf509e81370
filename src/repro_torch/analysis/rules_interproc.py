"""DLK009 interproc-host-sync + DLK011 ownership-handoff.

Both rules ride on :class:`repro_torch.analysis.project.ProjectIndex` function
summaries (``ctx.project``), so taint and ownership cross function and
module boundaries — the exact escape hatch of the module-local DLK002 /
DLK006 / DLK007: the moment a counted step's result or a pool/tracer
handle is passed to a helper, the local rules lose it.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       register)
from repro_torch.analysis.rules_host import _sync_call
from repro_torch.analysis.rules_obs import _tracer_receiver
from repro_torch.analysis.rules_refcount import _pool_receiver


def _in_loop(ctx: ModuleContext, node, fn) -> bool:
    """Is ``node`` inside a loop that belongs to ``fn`` (not an outer one)?"""
    for anc in ctx.ancestors(node):
        if anc is fn:
            return False
        if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
            return True
    return False


@register
class InterprocHostSync(Rule):
    """Device value synced to host inside a helper called from a hot loop.
    DLK002 stops at the function boundary; this rule follows the call graph:
    the helper's summary says which of its parameters it syncs (DLK002's
    torch sync set: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")``, ``int()``/``float()``/``bool()``, ``np.asarray``), and
    the caller's taint says which arguments hold results of counted
    calls."""

    code = "DLK009"
    name = "interproc-host-sync"
    skip_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        proj = ctx.project
        if proj is None:
            return
        for fn in ctx.functions:
            if not any(isinstance(n, (ast.For, ast.AsyncFor, ast.While))
                       for n in ast.walk(fn)):
                continue
            device = proj.device_names(ctx, fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if not _in_loop(ctx, node, fn):
                    continue
                if _sync_call(node, ctx) is not None:
                    continue                    # direct sync: DLK002's beat
                target = proj.resolve_call(ctx, node)
                if target is None:
                    continue
                info, bound = target
                summ = proj.summaries.get(info.fq)
                if summ is None or not summ.syncs_params:
                    continue
                for pi, arg in proj.map_args(node, info, bound).items():
                    if pi not in summ.syncs_params:
                        continue
                    tainted = any(
                        (isinstance(sub, ast.Name) and sub.id in device)
                        or (isinstance(sub, ast.Call)
                            and proj.is_device_call(ctx, sub))
                        for sub in ast.walk(arg))
                    if not tainted:
                        continue
                    param = summ.params[pi] if pi < len(summ.params) \
                        else f"#{pi}"
                    site = summ.sync_sites.get(pi, "host sync")
                    yield ctx.finding(
                        self, node,
                        f"device value flows into {info.fq}() which syncs "
                        f"its '{param}' argument to host ({site}) — called "
                        f"every iteration of a loop in '{fn.name}', this "
                        "stalls the launch queue just like an inline sync")
                    break


def _handle_call(call: ast.Call, ctx: ModuleContext):
    """(kind, receiver) if this call mints an owned handle: a pool block
    (``<pool>.alloc()``) or a tracer span (``<tracer>.begin/span()``)."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr == "alloc":
        recv = _pool_receiver(call.func)
        if recv is not None:
            return "block", recv
    if attr in ("begin", "span"):
        recv = _tracer_receiver(call.func)
        if recv is not None:
            return "span", recv
    return None


@register
class OwnershipHandoff(Rule):
    """Block/span handle passed to a function that does not consume it.
    DLK006/DLK007 treat any call argument as an ownership transfer; with a
    resolved callee summary we know whether the callee actually stores,
    returns, frees, or ends the handle — if it does not, and no other use
    settles ownership here, the handle leaks across the call boundary."""

    code = "DLK011"
    name = "ownership-handoff"
    skip_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        proj = ctx.project
        if proj is None:
            return
        from repro_torch.analysis.project import CONSUME_METHODS
        for fn in ctx.functions:
            handles = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call):
                    minted = _handle_call(node.value, ctx)
                    if minted is not None:
                        handles[node.targets[0].id] = (node, minted)
            for name in sorted(handles):
                bind, (kind, recv) = handles[name]
                uses = [n for n in ast.walk(fn)
                        if isinstance(n, ast.Name) and n.id == name
                        and isinstance(n.ctx, ast.Load)]
                if not uses:
                    continue        # dropped handle: DLK006/DLK007 territory
                consumed = False
                handoffs = []
                for use in uses:
                    verdict = self._classify(ctx, proj, fn, use,
                                             CONSUME_METHODS)
                    if verdict == "consumed":
                        consumed = True
                        break
                    if verdict is not None:
                        handoffs.append(verdict)
                if consumed or not handoffs:
                    continue
                call, info = handoffs[0]
                yield ctx.finding(
                    self, call,
                    f"{kind} handle '{name}' from {recv}."
                    f"{bind.value.func.attr}() is passed to {info.fq}(), "
                    "which neither stores, returns, frees, nor ends it — "
                    "and no other use here settles ownership (leak)")

    @staticmethod
    def _classify(ctx, proj, fn, use, consume_methods):
        """'consumed', (call, info) for a non-consuming handoff, or None
        for a neutral use (guard test, attribute read)."""
        parent = ctx.parent(use)
        for anc in ctx.ancestors(use):
            if anc is fn:
                break
            if isinstance(anc, (ast.Return, ast.Yield, ast.YieldFrom)):
                return "consumed"
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                if any(use is sub or any(s is use for s in
                                         ast.walk(item.context_expr))
                       for item in anc.items
                       for sub in [item.context_expr]):
                    return "consumed"
            if isinstance(anc, ast.Assign) and any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in anc.targets):
                return "consumed"
        # h.end()/h.free()/h.close()/h.release()
        if isinstance(parent, ast.Attribute) \
                and parent.attr in consume_methods:
            gp = ctx.parent(parent)
            if isinstance(gp, ast.Call) and gp.func is parent:
                return "consumed"
        # argument to a call
        if isinstance(parent, ast.Call) and use is not parent.func:
            in_args = any(a is use for a in parent.args) or any(
                kw.value is use for kw in parent.keywords)
            if in_args:
                target = proj.resolve_call(ctx, parent)
                if target is None:
                    return "consumed"   # unresolvable: assume transfer
                info, bound = target
                summ = proj.summaries.get(info.fq)
                if summ is None:
                    return "consumed"
                for pi, arg in proj.map_args(parent, info, bound).items():
                    if arg is use:
                        if pi in summ.consumes_params:
                            return "consumed"
                        return (parent, info)
                return "consumed"       # star-args etc.: assume transfer
        return None
