"""DLK002 host-sync-in-hot-loop.

The engines are designed around *one* host sync per step (the [B,1]
token fetch). CUDA launches are asynchronous: any extra ``.item()``,
``.cpu()``, ``.numpy()``, ``.tolist()``, ``.to("cpu")``, ``int()``/
``float()``/``bool()`` or ``np.asarray`` of a device tensor inside the step
loop blocks the host until the card drains, serializes host and device
and, per PAPER.md, burns idle watts meanwhile. The rule taints results of
counted calls (``counting_call`` steps and the ``make_*`` factories'
steps), propagates the taint through plain assignments, and flags sync
calls on tainted values inside a loop. A device-wide barrier
(``torch.cuda.synchronize()``, ``<stream or event>.synchronize()``) needs
no tainted operand: it is flagged anywhere in such a loop.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       qualname, register, root_name)

#: ``f(x)`` forms that copy a tensor to host
SYNC_QUALNAMES = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                  "onp.asarray"}
#: ``x.m()`` forms that copy a tensor to host (and so wait for it)
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: builtins that concretize a scalar
SYNC_BUILTINS = {"int", "float", "bool"}


def _is_host_device(node) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) \
        and qualname(node.func) in ("torch.device", "device") \
        and len(node.args) == 1 and _is_host_device(node.args[0])


def _sync_call(node: ast.Call, ctx: ModuleContext):
    """(kind, synced-expression) if this call copies a value to host,
    else None."""
    qn = qualname(node.func)
    if qn in SYNC_QUALNAMES and node.args:
        return qn, node.args[0]
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in SYNC_METHODS:
            return f".{attr}()", node.func.value
        if attr == "to" and (
                any(_is_host_device(a) for a in node.args[:1])
                or any(kw.arg == "device" and _is_host_device(kw.value)
                       for kw in node.keywords)):
            return '.to("cpu")', node.func.value
    if isinstance(node.func, ast.Name) and node.func.id in SYNC_BUILTINS \
            and len(node.args) == 1:
        return f"{node.func.id}()", node.args[0]
    return None


def _barrier_call(node: ast.Call, ctx: ModuleContext) -> Optional[str]:
    """Kind text if this call waits for the device as a whole:
    ``torch.cuda.synchronize()`` or ``<stream or event>.synchronize()``."""
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr == "synchronize":
        return f"{qualname(node.func) or '.synchronize'}()"
    if isinstance(node.func, ast.Name) \
            and ctx.torch_name(node.func).endswith("cuda.synchronize"):
        return "synchronize()"
    return None


def _device_taint(fn: ast.FunctionDef, ctx: ModuleContext) -> Set[str]:
    """Names in ``fn`` holding device values: results of calls to counted
    steps, propagated through assignments. Assigning a sync result
    *clears* the taint (the copy lives on host)."""
    tainted: Set[str] = set()

    def value_tainted(expr) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                if ctx.is_counted_call(sub):
                    return True
            elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id in tainted:
                return True
        return False

    # two passes: taint introduced late in a loop body flows to syncs
    # earlier in the same body on the next iteration
    for _ in range(2):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            is_sync = isinstance(node.value, ast.Call) \
                and _sync_call(node.value, ctx) is not None
            hot = value_tainted(node.value) and not is_sync
            for tgt in node.targets:
                for t in (tgt.elts if isinstance(tgt, ast.Tuple)
                          else [tgt]):
                    if isinstance(t, ast.Name):
                        (tainted.add if hot else tainted.discard)(t.id)
    return tainted


@register
class HostSyncInHotLoop(Rule):
    """Host sync on a device tensor inside a loop of a function that drives
    counted steps. Each one stalls the launch queue; the engines budget
    exactly one per decode step."""

    code = "DLK002"
    name = "host-sync"
    skip_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ctx.functions:
            if not ctx.calls_counted(fn):
                continue
            tainted = _device_taint(fn, ctx)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                loop = ctx.enclosing(node, (ast.For, ast.While))
                if loop is None or ctx.enclosing_function(loop) is not fn:
                    continue
                barrier = _barrier_call(node, ctx)
                if barrier is not None:
                    yield ctx.finding(
                        self, node,
                        f"device barrier {barrier} in the hot loop of "
                        f"'{fn.name}' — the host waits for the card every "
                        "iteration")
                    continue
                sync = _sync_call(node, ctx)
                if sync is None:
                    continue
                kind, expr = sync
                root = root_name(expr)
                roots = {root} if root else {
                    n.id for n in ast.walk(expr)
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
                hits = roots & tainted
                if hits:
                    yield ctx.finding(
                        self, node,
                        f"host sync {kind} on device value "
                        f"'{sorted(hits)[0]}' in the hot loop of "
                        f"'{fn.name}' — stalls the launch queue every "
                        "iteration")
