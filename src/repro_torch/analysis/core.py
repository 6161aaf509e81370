"""dalek-lint core: findings, the rule registry, pragma suppression, and
the entry points that lint files.

The analyzer is pure stdlib ``ast``: each rule is a class with a ``DLK###``
code and a kebab-case slug, registered via :func:`register`, that inspects
one :class:`ModuleContext` (parsed tree + parent links + shared caches like
the module's counted step names) and yields :class:`Finding`s. Suppression
is line-based pragmas::

    x = cur.cpu().numpy()  # dalek: allow[host-sync] one fetch per step

A pragma on its own comment line covers the next statement line; the token
inside ``allow[...]`` is a rule slug, a DLK code, or ``all``. Suppressed
findings are kept (and counted) but never fail the run — the gate
regresses on the *non-suppressed* count.

Where the JAX linter tracks jit-wrapped names, this one tracks *counted*
names: a step runs eagerly, and the one place its executions are metered
is :func:`repro_torch.core.tracing.counting_call`.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

PRAGMA_RE = re.compile(r"#\s*dalek:\s*allow\[([A-Za-z0-9_,\- *]+)\]")

#: basenames treated as test files (rules with ``skip_tests`` pass them by:
#: tests run fresh reference computations and sync on results *by design*)
_TEST_RE = re.compile(r"^(test_.*|conftest)\.py$")


@dataclasses.dataclass
class Finding:
    code: str            # "DLK001"
    rule: str            # "bare-compile"
    path: str            # posix, as given on the command line
    line: int
    col: int
    message: str
    line_text: str = ""
    #: last source line of the reported node's *header* — a pragma anywhere
    #: in [line, end_line] suppresses (wrapped calls span several lines)
    end_line: int = 0
    suppressed: bool = False
    baselined: bool = False

    @property
    def active(self) -> bool:
        return not (self.suppressed or self.baselined)

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def render(self) -> str:
        note = (" (suppressed)" if self.suppressed
                else " (baselined)" if self.baselined else "")
        return f"{self.location}: {self.code} [{self.rule}] {self.message}{note}"

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def key(self):
        """Baseline identity: line numbers churn, source text doesn't."""
        return (self.code, self.path, self.line_text.strip())


class Rule:
    """One check. Subclasses set ``code``/``name`` and implement ``check``."""

    code: str = "DLK000"
    name: str = "unnamed"
    #: rules that meter production discipline skip test files: tests run
    #: fresh references and sync on results on purpose
    skip_tests: bool = False

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        raise NotImplementedError


REGISTRY: List[type] = []


def register(cls):
    REGISTRY.append(cls)
    return cls


def all_rules() -> List[Rule]:
    return [cls() for cls in REGISTRY]


def rule_codes() -> List[str]:
    return sorted(cls.code for cls in REGISTRY)


# ---------------------------------------------------------------------------
# AST helpers shared by rules


def qualname(node) -> str:
    """Dotted source name for Name/Attribute chains ("self.pages.alloc");
    empty string for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def root_name(node) -> str:
    """Base variable of an expression: ``a.b[c].d`` -> "a"."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def is_counting_call(node) -> bool:
    """A reference to ``counting_call`` (bare or module-qualified)."""
    qn = qualname(node)
    return qn == "counting_call" or qn.endswith(".counting_call")


def assign_names(targets) -> List[str]:
    """Plain names and attribute names bound by assignment targets
    (``a, self.b = ...`` -> ["a", "b"])."""
    out: List[str] = []
    for tgt in targets:
        for t in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                  else [tgt]):
            if isinstance(t, ast.Name):
                out.append(t.id)
            elif isinstance(t, ast.Attribute):
                out.append(t.attr)
    return out


def factory_steps(fn) -> List[ast.FunctionDef]:
    """Inner defs a ``make_*`` step factory returns by name (the repo's
    step-factory convention: ``make_decode_step`` returns ``decode_step``)."""
    if not fn.name.startswith("make_"):
        return []
    inner = {n.name: n for n in fn.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out: List[ast.FunctionDef] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Name) \
                and node.value.id in inner \
                and inner[node.value.id] not in out:
            out.append(inner[node.value.id])
    return out


class ModuleContext:
    """One parsed module + the caches rules share."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.is_test = bool(_TEST_RE.match(Path(path).name))
        #: set by :class:`repro_torch.analysis.project.ProjectIndex` —
        #: dotted module name, per-module import table, and the owning
        #: whole-program index. ``analyze_source`` builds a one-module
        #: index, so interprocedural rules see a project even in
        #: single-file mode.
        self.module_name: str = Path(path).stem
        self.import_table: Dict[str, str] = {}
        self.project = None  # type: Optional["ProjectIndex"]
        self._parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent
        #: names bound by ``from torch... import ...`` in this module,
        #: mapped to their dotted origin (``graph`` -> ``torch.cuda.graph``)
        self.torch_imports: Dict[str, str] = {
            alias.asname or alias.name: f"{node.module}.{alias.name}"
            for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
            and (node.module or "").split(".")[0] == "torch"
            for alias in node.names}
        self._counted_names: Optional[Set[str]] = None
        self._functions: Optional[List[ast.FunctionDef]] = None

    # -- structure -----------------------------------------------------------

    def parent(self, node) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def ancestors(self, node) -> Iterator[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing(self, node, kinds) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, kinds):
                return anc
        return None

    def enclosing_function(self, node):
        return self.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))

    def enclosing_class(self, node) -> Optional[ast.ClassDef]:
        return self.enclosing(node, ast.ClassDef)

    @property
    def functions(self) -> List[ast.FunctionDef]:
        if self._functions is None:
            self._functions = [n for n in ast.walk(self.tree)
                               if isinstance(n, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))]
        return self._functions

    def torch_name(self, node) -> str:
        """Dotted name of a reference with ``from torch... import``
        aliases resolved (``graph`` -> ``torch.cuda.graph``)."""
        qn = qualname(node)
        head, dot, rest = qn.partition(".")
        if head in self.torch_imports:
            return self.torch_imports[head] + dot + rest
        return qn

    # -- counted-step tracking -----------------------------------------------

    @property
    def counted_names(self) -> Set[str]:
        """Plain names and attribute names of counted steps: bound to
        ``counting_call(...)`` (``step = counting_call(...)``,
        ``self._decode = counting_call(...)``), or the inner defs the
        module's ``make_*`` step factories return."""
        if self._counted_names is not None:
            return self._counted_names
        names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and is_counting_call(node.value.func):
                names.update(assign_names(node.targets))
        for fn in self.functions:
            names.update(f.name for f in factory_steps(fn))
        self._counted_names = names
        return names

    def is_counted_call(self, call) -> bool:
        """A direct call of a counted name."""
        f = call.func
        counted = self.counted_names
        return (isinstance(f, ast.Name) and f.id in counted) or (
            isinstance(f, ast.Attribute) and f.attr in counted)

    def calls_counted(self, func_node: ast.FunctionDef) -> bool:
        """Does this function directly call a counted step?"""
        return any(isinstance(node, ast.Call) and self.is_counted_call(node)
                   for node in ast.walk(func_node))

    # -- findings ------------------------------------------------------------

    def finding(self, rule: Rule, node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        # pragma span: every line of the *enclosing statement* for
        # expression findings (a wrapped call can carry its allow[] on the
        # closing-paren line), but only the *header* for statements with a
        # body (an allow[] inside an if/with body must not blanket-suppress
        # the whole block)
        span = node
        while span is not None and not isinstance(span, ast.stmt):
            span = self.parent(span)
        span = span or node
        end = getattr(span, "end_lineno", None) or line
        body = getattr(span, "body", None)
        if isinstance(body, list) and body and hasattr(body[0], "lineno"):
            end = max(line, body[0].lineno - 1)
        return Finding(code=rule.code, rule=rule.name, path=self.path,
                       line=line, col=col, message=message,
                       line_text=text, end_line=end)


# ---------------------------------------------------------------------------
# suppression pragmas


def _pragma_rules(line: str) -> Set[str]:
    out: Set[str] = set()
    for m in PRAGMA_RE.finditer(line):
        out |= {tok.strip().lower() for tok in m.group(1).split(",")
                if tok.strip()}
    return out


def suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """line number (1-based) -> allowed rule tokens. A pragma on a pure
    comment line also covers the following line."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        toks = _pragma_rules(line)
        if not toks:
            continue
        out.setdefault(i, set()).update(toks)
        if line.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).update(toks)
    return out


def _is_allowed(finding: Finding, allowed: Dict[int, Set[str]]) -> bool:
    last = max(finding.end_line, finding.line)
    for line in range(finding.line, last + 1):
        toks = allowed.get(line, ())
        if toks and ("all" in toks or "*" in toks
                     or finding.rule in toks
                     or finding.code.lower() in toks):
            return True
    return False


# ---------------------------------------------------------------------------
# entry points

#: parsed-AST cache keyed by source content hash — project mode parses the
#: whole tree once per *content*, so repeated runs (and the same file reached
#: through several roots) are free
_AST_CACHE: Dict[str, ast.Module] = {}
_AST_CACHE_MAX = 2048


def parse_cached(source: str) -> ast.Module:
    key = hashlib.sha256(source.encode("utf-8", "replace")).hexdigest()
    tree = _AST_CACHE.get(key)
    if tree is None:
        tree = ast.parse(source)
        if len(_AST_CACHE) >= _AST_CACHE_MAX:
            _AST_CACHE.clear()
        _AST_CACHE[key] = tree
    return tree


def check_module(ctx: ModuleContext,
                 rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run every (selected) rule over one prepared module context."""
    allowed = suppressions(ctx.lines)
    findings: List[Finding] = []
    seen = set()
    for rule in (rules if rules is not None else all_rules()):
        if rule.skip_tests and ctx.is_test:
            continue
        for f in rule.check(ctx):
            # one finding per (rule, line): compound expressions (e.g.
            # int(x.cpu().numpy()[0])) must not double-report
            if (f.code, f.line) in seen:
                continue
            seen.add((f.code, f.line))
            if _is_allowed(f, allowed):
                f.suppressed = True
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def analyze_source(source: str, path: str,
                   rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run every (selected) rule over one module's source."""
    try:
        tree = parse_cached(source)
    except SyntaxError as e:
        return [Finding(code="DLK000", rule="parse-error", path=path,
                        line=e.lineno or 1, col=e.offset or 0,
                        message=f"could not parse: {e.msg}")]
    ctx = ModuleContext(path, source, tree)
    # a one-module project: interprocedural rules work on single files too
    from repro_torch.analysis.project import ProjectIndex
    ProjectIndex([ctx])
    return check_module(ctx, rules)


def iter_py_files(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


def select_rules(select: Optional[Iterable[str]] = None,
                 ignore: Optional[Iterable[str]] = None) -> List[Rule]:
    def norm(vals):
        return {v.strip().lower() for v in vals or () if v.strip()}

    sel, ign = norm(select), norm(ignore)

    def match(rule, toks):
        return rule.code.lower() in toks or rule.name in toks

    rules = [r for r in all_rules() if not sel or match(r, sel)]
    return [r for r in rules if not match(r, ign)]


def analyze_paths(paths: Iterable[str],
                  select: Optional[Iterable[str]] = None,
                  ignore: Optional[Iterable[str]] = None) -> List[Finding]:
    rules = select_rules(select, ignore)
    findings: List[Finding] = []
    for file in iter_py_files(paths):
        try:
            source = file.read_text()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(
                code="DLK000", rule="parse-error", path=file.as_posix(),
                line=1, col=0, message=f"could not read: {e}"))
            continue
        findings.extend(analyze_source(source, file.as_posix(), rules))
    return findings
