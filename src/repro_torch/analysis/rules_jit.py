"""Step-hygiene rules: DLK001 bare-compile, DLK003 device-branch,
DLK004 step-kwargs.

The JAX linter's jit rules, retargeted to what an eager PyTorch step can
get wrong: an executable or a CUDA-graph capture that ``TraceStats`` never
sees, a Python branch that reads a tensor's value inside a step, and
``counting_call`` wiring that makes every call look like a new compile.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       factory_steps, is_counting_call,
                                       qualname, register)

#: references that build an executable or a graph capture
COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
             "torch.jit.trace_module", "torch.cuda.graph",
             "torch.cuda.CUDAGraph", "torch.cuda.make_graphed_callables",
             "torch.cuda.graphs.graph", "torch.cuda.graphs.CUDAGraph",
             "torch.cuda.graphs.make_graphed_callables"}

#: the module whose functions may build them: ``core/tracing.py``
_TRACING = ("core", "tracing.py")


@register
class BareCompile(Rule):
    """A compile or capture outside ``counting_call``.

    Counted steps are the serving metric's compile count: one count per
    new abstract signature (``repro_torch.core.tracing``). An executable
    from ``torch.compile`` or ``torch.jit.script``/``trace``, or a capture
    from ``torch.cuda.graph``, ``torch.cuda.CUDAGraph`` or
    ``torch.cuda.make_graphed_callables``, recompiles or recaptures where
    ``TraceStats`` cannot see it, so the run stats, the telemetry counters
    and the gate miss it. Build it inside the ``counting_call(...)``
    expression that wraps the step, or in a function of
    ``core/tracing.py``, or justify it with
    ``# dalek: allow[bare-compile]``. Fix-only: never baselined.

    Skips test files: tests compile fresh reference computations by
    design and have no compile budget to meter.
    """

    code = "DLK001"
    name = "bare-compile"
    skip_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        in_tracing = tuple(ctx.path.split("/")[-2:]) == _TRACING
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            name = ctx.torch_name(node)
            if name not in COMPILERS:
                continue
            if isinstance(ctx.parent(node), ast.Attribute):
                continue        # a prefix of a longer reference
            if in_tracing and ctx.enclosing_function(node) is not None:
                continue        # the one sanctioned wrapper's module
            if any(isinstance(anc, ast.Call) and is_counting_call(anc.func)
                   for anc in ctx.ancestors(node)):
                continue        # counting_call(torch.compile(f), "step")
            yield ctx.finding(
                self, node,
                f"bare {name}: its compiles/captures are invisible to "
                "TraceStats and the compile gate — build it inside "
                "counting_call (repro_torch.core.tracing)")


def _step_bodies(ctx: ModuleContext) -> List[ast.FunctionDef]:
    """Every function that runs as a counted step: passed by name to
    ``counting_call``, or an inner def returned by a ``make_*`` step
    factory (this repo's step-factory convention)."""
    defs: Dict[str, ast.FunctionDef] = {}
    for fn in ctx.functions:
        defs.setdefault(fn.name, fn)
    bodies: Dict[int, ast.FunctionDef] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and is_counting_call(node.func) \
                and node.args and isinstance(node.args[0], ast.Name) \
                and node.args[0].id in defs:
            fn = defs[node.args[0].id]
            bodies.setdefault(id(fn), fn)
    for fn in ctx.functions:
        for inner in factory_steps(fn):
            bodies.setdefault(id(inner), inner)
    return list(bodies.values())


#: annotations that mark a parameter as a host value, not a tensor
_HOST_TYPES = {"int", "float", "bool", "str"}


def _host_param(arg: ast.arg) -> bool:
    """``n: int``, ``flag: bool``, ``Optional[int]``: a host value, which a
    branch may read without touching the device."""
    ann = arg.annotation
    if isinstance(ann, ast.Subscript) and qualname(ann.value).endswith(
            "Optional"):
        ann = ann.slice
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in _HOST_TYPES
    return qualname(ann) in _HOST_TYPES


#: calls and attributes that read only a tensor's metadata
SAFE_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "callable"}
SAFE_ATTRS = {"shape", "dtype", "ndim", "device", "numel", "size", "dim",
              "is_floating_point", "requires_grad", "is_cuda"}


def _value_names(test: ast.AST) -> Set[str]:
    """Names whose *value* the expression reads — excluding metadata-only
    uses: ``is``/``is not`` comparisons, len()/isinstance()-style
    introspection, and ``.shape``/``.dtype``/``.ndim``/``.device``/
    ``.numel()``/``.size()`` (host-side in eager torch, and fixed under a
    CUDA-graph capture)."""
    out: Set[str] = set()

    def walk(node):
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in SAFE_CALLS:
            return
        if isinstance(node, ast.Attribute) and node.attr in SAFE_ATTRS:
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            out.add(node.id)
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(test)
    return out


@register
class DeviceBranch(Rule):
    """Python ``if``/``while``/``assert``/ternary on a tensor's value
    inside a counted step body.

    The JAX rule's traced branch. In eager torch the test is a hidden
    ``.item()``: the host waits for the card in the middle of the step,
    every step. Under CUDA-graph capture it is an error (the capture
    cannot read a value), or, captured once, it freezes the branch the
    first call took. Tensor parameters of the body (every parameter but
    ``self`` and those annotated ``int``/``float``/``bool``/``str``) are
    tainted, and the taint flows through plain assignments of their
    values; ``.shape``, ``.dtype``, ``.ndim``, ``.device``, ``.numel()``
    and ``.size()``, ``is`` comparisons, ``len`` and ``isinstance`` read
    metadata only and stay safe.
    """

    code = "DLK003"
    name = "device-branch"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _step_bodies(ctx):
            args = fn.args
            tainted = {a.arg for a in args.args + args.posonlyargs
                       + args.kwonlyargs
                       if a.arg != "self" and not _host_param(a)}
            inner_fns = {id(f) for f in ast.walk(fn)
                         if isinstance(f, (ast.FunctionDef, ast.Lambda))
                         and f is not fn}
            for node in ast.walk(fn):
                # taint flows through plain assignments of a tensor's value
                if isinstance(node, ast.Assign):
                    if _value_names(node.value) & tainted:
                        for tgt in node.targets:
                            for t in (tgt.elts if isinstance(tgt, ast.Tuple)
                                      else [tgt]):
                                if isinstance(t, ast.Name):
                                    tainted.add(t.id)
                if not isinstance(node, (ast.If, ast.While, ast.Assert,
                                         ast.IfExp)):
                    continue
                if any(id(a) in inner_fns for a in ctx.ancestors(node)):
                    continue    # nested defs have their own params
                hits = _value_names(node.test) & tainted
                if hits:
                    kind = type(node).__name__.lower()
                    yield ctx.finding(
                        self, node,
                        f"python {kind} on a tensor's value "
                        f"({', '.join(sorted(hits))}) inside counted step "
                        f"'{fn.name}' — a hidden .item() every step, and "
                        "an error under CUDA-graph capture")


#: calls that build a numpy array or scalar on the host
_NUMPY_HEADS = ("np.", "numpy.", "onp.")
#: methods whose result is a host array or list
_HOST_ARRAY_METHODS = {"numpy", "tolist"}
#: ``counting_call``'s own parameters
_COUNTING_KWARGS = {"fn", "name", "stats", "on_compile"}


def _arrayish(expr, host_arrays: Set[str]) -> str:
    """Text of a non-tensor array-shaped argument (a numpy array or
    scalar, a list from ``.tolist()``), or "" for anything else."""
    if isinstance(expr, ast.Name) and expr.id in host_arrays:
        return expr.id
    if isinstance(expr, ast.Call):
        qn = qualname(expr.func)
        if qn.startswith(_NUMPY_HEADS):
            return f"{qn}(...)"
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _HOST_ARRAY_METHODS:
            return f".{expr.func.attr}()"
    return ""


@register
class StepKwargsHygiene(Rule):
    """``counting_call`` wiring that defeats the compile count.

    The count is keyed on ``name`` and on each call's abstract signature
    (``core/tracing.py:_describe``): tensors by shape, dtype and device,
    Python ints and floats as dynamic scalars, everything else by its
    ``repr``. So the rule flags:

    * a ``name`` that is not a string literal (or missing): the counter's
      key then changes with the run, and the gates that read ``prefill``/
      ``decode`` counts read nothing;
    * keywords ``counting_call`` does not take (``static_argnums``,
      ``donate_argnums``, ...): a TypeError at the call, and a sign the
      JAX wiring was carried over;
    * an array-shaped non-tensor argument to a counted step: a numpy
      array or numpy scalar goes into the signature by ``repr``, so each
      new value counts as a new compile; a list from ``.tolist()`` by its
      length and elements, so each new length does (and ``.tolist()`` is
      a host sync). Pass a tensor.

    The JAX rule's argnums range, static/donate overlap, array-shaped
    static and use-after-donate checks have no counterpart: ``counting_call``
    has no static or donated arguments (every non-tensor argument is
    static by construction, and eager steps donate nothing).
    """

    code = "DLK004"
    name = "step-kwargs"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and is_counting_call(node.func):
                yield from self._wiring(ctx, node)
        for fn in ctx.functions:
            host_arrays: Set[str] = set()
            # an assignment takes effect after the calls in its value
            for node in sorted((n for n in ast.walk(fn)
                                if isinstance(n, (ast.Assign, ast.Call))),
                               key=lambda n: (n.end_lineno, n.end_col_offset)
                               if isinstance(n, ast.Assign)
                               else (n.lineno, n.col_offset)):
                if isinstance(node, ast.Assign):
                    names = {t.id for t in node.targets
                             if isinstance(t, ast.Name)}
                    if _arrayish(node.value, host_arrays):
                        host_arrays |= names
                    else:
                        host_arrays -= names
                    continue
                if not ctx.is_counted_call(node):
                    continue
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    what = _arrayish(arg, host_arrays)
                    if what:
                        yield ctx.finding(
                            self, node,
                            f"array-shaped non-tensor argument ({what}) "
                            f"to counted step '{qualname(node.func)}' — "
                            "counting_call describes it by value or by "
                            "length, so each new one counts as a compile; "
                            "pass a tensor")
                        break

    def _wiring(self, ctx, call) -> Iterator[Finding]:
        name = call.args[1] if len(call.args) > 1 else next(
            (kw.value for kw in call.keywords if kw.arg == "name"), None)
        if not (isinstance(name, ast.Constant)
                and isinstance(name.value, str)):
            yield ctx.finding(
                self, call,
                "counting_call without a literal name — the compile "
                "counter's key changes with the run, and gates that read "
                "a step's count by name see none")
        extra = sorted(kw.arg for kw in call.keywords
                       if kw.arg and kw.arg not in _COUNTING_KWARGS)
        if extra:
            yield ctx.finding(
                self, call,
                f"counting_call takes no {', '.join(extra)} — it has no "
                "static or donated arguments (every non-tensor argument "
                "is static by value)")
