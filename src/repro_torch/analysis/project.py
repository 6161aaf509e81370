"""Whole-program layer: :class:`ProjectIndex` + function summaries.

Module-local rules stop at a function boundary — the exact bug classes the
repo keeps fixing by hand escape them (a counted step's result synced
inside a helper, a pool block handed to a function that forgets to free
it). This
module parses the full source tree once (content-hash AST cache), resolves
imports and aliases to fully-qualified symbols, builds a call graph, and
propagates per-function summaries to a fixpoint:

* ``syncs_params``    — which parameters the function copies to host
                        (``.item()``/``.cpu()``/``.numpy()``/``int()`` …,
                        or passing them to a callee that does);
* ``returns_device``  — the return value holds a device tensor (result of
                        a counted call, directly or transitively);
* ``consumes_params`` — a block/span handle parameter is stored, returned,
                        entered with ``with``, freed/ended, or forwarded to
                        a consuming callee.

Interprocedural rules (DLK009 interproc-host-sync, DLK011
ownership-handoff, DLK012 unguarded-shared-state) read these through
``ctx.project``. ``analyze_source`` attaches a one-module index so the
rules also run in single-file mode; ``analyze_project`` builds the full
index over every path. All output is deterministic regardless of file
discovery order: contexts are sorted by path, the fixpoint iterates
functions in (path, line) order, and call-site tables are built from the
sorted context list.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (Finding, ModuleContext,
                                       check_module, iter_py_files,
                                       parse_cached, qualname, root_name,
                                       select_rules)
from repro_torch.analysis.rules_host import _sync_call

#: ``h.<meth>()`` forms that settle a block/span handle's ownership
CONSUME_METHODS = {"end", "close", "free", "release"}

#: fixpoint ceiling — summaries are monotone over a call graph whose
#: realistic depth is far below this; the cap only bounds pathological cycles
_MAX_ROUNDS = 10


def _module_names(path: str) -> List[str]:
    """Dotted names this file answers to, most canonical first.

    The canonical name walks up the ``__init__.py`` chain
    (``src/repro_torch/serve/engine.py`` → ``repro_torch.serve.engine``); a
    path-derived ``<parent>.<stem>`` alias covers script-style imports
    (``benchmarks.bench_serving``), and the bare stem covers
    ``import engine`` siblings.
    """
    p = Path(path)
    stem = p.stem
    names: List[str] = []
    pkg_parts = [] if stem == "__init__" else [stem]
    cur = p.parent
    try:
        while cur.name and (cur / "__init__.py").exists():
            pkg_parts.insert(0, cur.name)
            cur = cur.parent
    except OSError:
        pass
    if pkg_parts:
        names.append(".".join(pkg_parts))
    if stem == "__init__":
        if p.parent.name and p.parent.name not in names:
            names.append(p.parent.name)
    else:
        if p.parent.name:
            alias = f"{p.parent.name}.{stem}"
            if alias not in names:
                names.append(alias)
        if stem not in names:
            names.append(stem)
    return names or [stem]


def _import_table(ctx: ModuleContext) -> Dict[str, str]:
    """local binding -> fully-qualified dotted target."""
    table: Dict[str, str] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    table[head] = head
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = ctx.module_name.split(".")[:-node.level]
                mod = ".".join(base + ([node.module] if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                target = f"{mod}.{a.name}" if mod else a.name
                table[a.asname or a.name] = target
    return table


@dataclasses.dataclass
class _FuncInfo:
    """One addressable function or method in the project."""
    fq: str                                   # canonical dotted name
    ctx: ModuleContext
    node: ast.FunctionDef
    class_node: Optional[ast.ClassDef] = None


@dataclasses.dataclass
class FunctionSummary:
    """Interprocedural facts about one function, built to a fixpoint."""
    params: Tuple[str, ...]
    syncs_params: Set[int] = dataclasses.field(default_factory=set)
    consumes_params: Set[int] = dataclasses.field(default_factory=set)
    returns_device: bool = False
    #: param index -> human-readable description of the sync site
    sync_sites: Dict[int, str] = dataclasses.field(default_factory=dict)

    def facts(self):
        return (frozenset(self.syncs_params),
                frozenset(self.consumes_params), self.returns_device)


class ProjectIndex:
    """Symbols, call resolution, and function summaries for a set of
    modules. Attaches itself to every context as ``ctx.project``."""

    def __init__(self, contexts: Sequence[ModuleContext]):
        self.contexts: List[ModuleContext] = sorted(
            contexts, key=lambda c: c.path)
        self.modules: Dict[str, ModuleContext] = {}
        self._aliases: Dict[str, List[str]] = {}
        for ctx in self.contexts:
            aliases = _module_names(ctx.path)
            ctx.module_name = aliases[0]
            ctx.project = self
            self._aliases[ctx.path] = aliases
            for name in aliases:
                self.modules.setdefault(name, ctx)
        for ctx in self.contexts:
            ctx.import_table = _import_table(ctx)

        #: dotted name (under every module alias) -> function info
        self.symbols: Dict[str, _FuncInfo] = {}
        #: dotted name -> (ctx, ClassDef)
        self.classes: Dict[str, Tuple[ModuleContext, ast.ClassDef]] = {}
        self._infos: List[_FuncInfo] = []
        for ctx in self.contexts:
            self._index_module(ctx)

        #: method name -> call sites ``<recv>.<name>(...)`` across all
        #: non-test modules (DLK012's guarded-call-site analysis)
        self.attr_calls: Dict[str, List[Tuple[ModuleContext, ast.Call]]] = {}
        for ctx in self.contexts:
            if ctx.is_test:
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute):
                    self.attr_calls.setdefault(
                        node.func.attr, []).append((ctx, node))

        #: id(node) -> its ``ast.walk`` list: the fixpoint walks every
        #: function once a round, and the trees outlive the index
        self._walks: Dict[int, List[ast.AST]] = {}
        self.summaries: Dict[str, FunctionSummary] = self._fixpoint()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_paths(cls, paths: Iterable[str]
                   ) -> Tuple["ProjectIndex", List[Finding]]:
        contexts: List[ModuleContext] = []
        errors: List[Finding] = []
        seen: Set[str] = set()
        for file in iter_py_files(paths):
            try:
                resolved = str(file.resolve())
            except OSError:
                resolved = str(file)
            if resolved in seen:
                continue
            seen.add(resolved)
            posix = file.as_posix()
            try:
                source = file.read_text()
            except (OSError, UnicodeDecodeError) as e:
                errors.append(Finding(
                    code="DLK000", rule="parse-error", path=posix,
                    line=1, col=0, message=f"could not read: {e}"))
                continue
            try:
                tree = parse_cached(source)
            except SyntaxError as e:
                errors.append(Finding(
                    code="DLK000", rule="parse-error", path=posix,
                    line=e.lineno or 1, col=e.offset or 0,
                    message=f"could not parse: {e.msg}"))
                continue
            contexts.append(ModuleContext(posix, source, tree))
        return cls(contexts), errors

    def _index_module(self, ctx: ModuleContext):
        canon = ctx.module_name
        aliases = self._aliases[ctx.path]
        for stmt in ctx.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = _FuncInfo(f"{canon}.{stmt.name}", ctx, stmt)
                self._infos.append(info)
                for alias in aliases:
                    self.symbols.setdefault(f"{alias}.{stmt.name}", info)
            elif isinstance(stmt, ast.ClassDef):
                for alias in aliases:
                    self.classes.setdefault(f"{alias}.{stmt.name}",
                                            (ctx, stmt))
                for meth in stmt.body:
                    if not isinstance(meth, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                        continue
                    info = _FuncInfo(f"{canon}.{stmt.name}.{meth.name}",
                                     ctx, meth, class_node=stmt)
                    self._infos.append(info)
                    for alias in aliases:
                        self.symbols.setdefault(
                            f"{alias}.{stmt.name}.{meth.name}", info)

    # -- symbol / call resolution --------------------------------------------

    def _candidates(self, ctx: ModuleContext, dotted: str) -> List[str]:
        parts = dotted.split(".")
        cands = []
        target = ctx.import_table.get(parts[0])
        if target:
            cands.append(".".join([target] + parts[1:]))
        cands.append(f"{ctx.module_name}.{dotted}")
        cands.append(dotted)
        return cands

    def _lookup_func(self, ctx: ModuleContext,
                     dotted: str) -> Optional[_FuncInfo]:
        for cand in self._candidates(ctx, dotted):
            info = self.symbols.get(cand)
            if info is not None:
                return info
        return None

    def _lookup_class(self, ctx: ModuleContext, dotted: str
                      ) -> Optional[Tuple[ModuleContext, ast.ClassDef]]:
        for cand in self._candidates(ctx, dotted):
            hit = self.classes.get(cand)
            if hit is not None:
                return hit
        return None

    def _method(self, ctx: ModuleContext, class_node: ast.ClassDef,
                meth: str, _seen=None) -> Optional[_FuncInfo]:
        """Look up a method on a class, following base classes."""
        _seen = _seen if _seen is not None else set()
        key = (ctx.path, class_node.name)
        if key in _seen:
            return None
        _seen.add(key)
        for stmt in class_node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == meth:
                return self.symbols.get(
                    f"{ctx.module_name}.{class_node.name}.{meth}")
        for base in class_node.bases:
            qn = qualname(base)
            if not qn:
                continue
            resolved = self._lookup_class(ctx, qn)
            if resolved is not None:
                hit = self._method(resolved[0], resolved[1], meth, _seen)
                if hit is not None:
                    return hit
        return None

    def resolve_call(self, ctx: ModuleContext, call: ast.Call
                     ) -> Optional[Tuple[_FuncInfo, bool]]:
        """(function info, bound?) for a call, or None if unresolvable.
        ``bound`` means the receiver supplies ``self`` (``self.m(...)``)."""
        f = call.func
        if isinstance(f, ast.Name):
            info = self._lookup_func(ctx, f.id)
            return (info, False) if info is not None else None
        if isinstance(f, ast.Attribute):
            qn = qualname(f)
            if not qn:
                return None
            head, _, rest = qn.partition(".")
            if head == "self" and rest and "." not in rest:
                cls = ctx.enclosing_class(call)
                if cls is not None:
                    info = self._method(ctx, cls, rest)
                    if info is not None:
                        return (info, True)
                return None
            info = self._lookup_func(ctx, qn)
            return (info, False) if info is not None else None
        return None

    @staticmethod
    def map_args(call: ast.Call, info: _FuncInfo,
                 bound: bool) -> Dict[int, ast.expr]:
        """callee param index -> caller argument expression."""
        args = info.node.args
        params = [a.arg for a in args.posonlyargs + args.args]
        offset = 1 if (bound and params and params[0] in ("self", "cls")) \
            else 0
        out: Dict[int, ast.expr] = {}
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            pi = i + offset
            if pi < len(params):
                out[pi] = arg
        for kw in call.keywords:
            if kw.arg and kw.arg in params:
                out[params.index(kw.arg)] = kw.value
        return out

    # -- dataflow ------------------------------------------------------------

    def _walk(self, node) -> List[ast.AST]:
        nodes = self._walks.get(id(node))
        if nodes is None:
            nodes = self._walks[id(node)] = list(ast.walk(node))
        return nodes

    def is_device_call(self, ctx: ModuleContext, call: ast.Call,
                       sums: Optional[Dict[str, FunctionSummary]] = None
                       ) -> bool:
        """Call that produces a device value: a counted step, or a
        resolved callee whose summary says returns_device."""
        sums = sums if sums is not None else self.summaries
        if ctx.is_counted_call(call):
            return True
        target = self.resolve_call(ctx, call)
        if target is None:
            return False
        callee = sums.get(target[0].fq)
        return bool(callee and callee.returns_device)

    def _flow(self, ctx: ModuleContext, fn: ast.FunctionDef,
              sums: Dict[str, FunctionSummary]
              ) -> Tuple[Dict[str, int], Set[str]]:
        """(param provenance, device-valued names) inside ``fn``.

        Provenance maps a local name to the parameter index it aliases
        (through plain assignments). Device names are results of counted /
        returns_device calls, propagated through assignments; two passes so
        taint introduced late in a loop body reaches earlier statements on
        the next iteration. Assigning a sync result clears the taint (the
        copy lives on host) — mirrors ``rules_host._device_taint``.
        """
        args = fn.args
        params = [a.arg for a in args.posonlyargs + args.args]
        prov: Dict[str, int] = {p: i for i, p in enumerate(params)}
        device: Set[str] = set()
        for _ in range(2):
            for node in self._walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                val = node.value
                src_idx = prov.get(val.id) if isinstance(val, ast.Name) \
                    else None
                is_sync = any(isinstance(sub, ast.Call)
                              and _sync_call(sub, ctx) is not None
                              for sub in self._walk(val))
                is_dev = not is_sync and any(
                    (isinstance(sub, ast.Call)
                     and self.is_device_call(ctx, sub, sums))
                    or (isinstance(sub, ast.Name)
                        and isinstance(sub.ctx, ast.Load)
                        and sub.id in device)
                    for sub in self._walk(val))
                for tgt in node.targets:
                    elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                        else [tgt]
                    for t in elts:
                        if not isinstance(t, ast.Name):
                            continue
                        if src_idx is not None:
                            prov[t.id] = src_idx
                        else:
                            prov.pop(t.id, None)
                        (device.add if is_dev else device.discard)(t.id)
        return prov, device

    def device_names(self, ctx: ModuleContext,
                     fn: ast.FunctionDef) -> Set[str]:
        """Names in ``fn`` holding device values (final summaries)."""
        return self._flow(ctx, fn, self.summaries)[1]

    # -- summaries -----------------------------------------------------------

    def _fixpoint(self) -> Dict[str, FunctionSummary]:
        sums: Dict[str, FunctionSummary] = {}
        order = sorted(self._infos,
                       key=lambda i: (i.ctx.path, i.node.lineno))
        for info in order:
            args = info.node.args
            sums[info.fq] = FunctionSummary(
                params=tuple(a.arg for a in args.posonlyargs + args.args))
        for _ in range(_MAX_ROUNDS):
            changed = False
            for info in order:
                new = self._summarize(info, sums)
                if new.facts() != sums[info.fq].facts():
                    changed = True
                sums[info.fq] = new
            if not changed:
                break
        return sums

    def _resolved(self, ctx, call, sums):
        target = self.resolve_call(ctx, call)
        if target is None:
            return None, None, False
        info, bound = target
        return sums.get(info.fq), info, bound

    def _summarize(self, info: _FuncInfo,
                   sums: Dict[str, FunctionSummary]) -> FunctionSummary:
        ctx, fn = info.ctx, info.node
        prov, device = self._flow(ctx, fn, sums)
        args = fn.args
        s = FunctionSummary(
            params=tuple(a.arg for a in args.posonlyargs + args.args))
        short = Path(ctx.path).name

        for node in self._walk(fn):
            if isinstance(node, ast.Call):
                sync = _sync_call(node, ctx)
                if sync is not None:
                    kind, expr = sync
                    idx = prov.get(root_name(expr))
                    if idx is not None:
                        s.syncs_params.add(idx)
                        s.sync_sites.setdefault(
                            idx, f"{kind} at {short}:{node.lineno}")
                    continue
                callee, cinfo, bound = self._resolved(ctx, node, sums)
                if callee is not None:
                    for pi, arg in self.map_args(node, cinfo, bound).items():
                        if pi not in callee.syncs_params:
                            continue
                        idx = prov.get(root_name(arg))
                        if idx is not None:
                            s.syncs_params.add(idx)
                            s.sync_sites.setdefault(
                                idx, callee.sync_sites.get(
                                    pi, f"via {cinfo.fq}()"))
            elif isinstance(node, ast.Return) and node.value is not None:
                v = node.value
                if isinstance(v, ast.Call) and _sync_call(v, ctx) is not None:
                    continue        # `return int(x)` comes back on host
                if any((isinstance(sub, ast.Call)
                        and self.is_device_call(ctx, sub, sums))
                       or (isinstance(sub, ast.Name) and sub.id in device)
                       for sub in self._walk(v)):
                    s.returns_device = True

        self._consumes(ctx, fn, prov, sums, s)
        return s

    def _consumes(self, ctx, fn, prov, sums, s: FunctionSummary):
        """Ownership: a handle param that is stored, returned, entered,
        freed/ended, or forwarded to a consuming (or unresolvable —
        conservative) callee counts as consumed."""
        for node in self._walk(fn):
            if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                val = getattr(node, "value", None)
                if val is None:
                    continue
                for sub in self._walk(val):
                    if isinstance(sub, ast.Name) and sub.id in prov:
                        s.consumes_params.add(prov[sub.id])
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    r = root_name(item.context_expr)
                    if r in prov:
                        s.consumes_params.add(prov[r])
            elif isinstance(node, ast.Assign):
                if any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in node.targets):
                    for sub in self._walk(node.value):
                        if isinstance(sub, ast.Name) and sub.id in prov:
                            s.consumes_params.add(prov[sub.id])
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id in prov \
                        and f.attr in CONSUME_METHODS:
                    s.consumes_params.add(prov[f.value.id])
                callee, cinfo, bound = self._resolved(ctx, node, sums)
                handle_args = [a for a in list(node.args)
                               + [kw.value for kw in node.keywords]
                               if isinstance(a, ast.Name) and a.id in prov]
                if callee is None:
                    for a in handle_args:
                        s.consumes_params.add(prov[a.id])
                else:
                    for pi, arg in self.map_args(node, cinfo, bound).items():
                        if isinstance(arg, ast.Name) and arg.id in prov \
                                and pi in callee.consumes_params:
                            s.consumes_params.add(prov[arg.id])


def analyze_project(paths: Iterable[str],
                    select: Optional[Iterable[str]] = None,
                    ignore: Optional[Iterable[str]] = None) -> List[Finding]:
    """Whole-program lint: one :class:`ProjectIndex` over every path, then
    every rule per module with cross-module resolution available."""
    rules = select_rules(select, ignore)
    index, findings = ProjectIndex.from_paths(paths)
    for ctx in index.contexts:
        findings.extend(check_module(ctx, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings
