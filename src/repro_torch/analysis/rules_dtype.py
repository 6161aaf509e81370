"""DLK010 dtype-drift — the carried-state retrace bug class.

``init_cache`` allocates carried state in one dtype (float32); if a step
function returns the carry after casting it into the *activation* dtype
(``state.to(x.dtype)`` for the concat, then returning a slice of the
result), the carry's abstract signature changes between step 1 and step 2:
``counting_call`` counts a second decode "compile", a CUDA-graph capture
of the step would have to be taken again, and the state loses precision
every step — exactly what ``xlstm._causal_conv`` does without its pin.

The rule runs a per-function three-value lattice over names:

* ``CARRY`` — a parameter whose name looks like carried state
  (``state``/``carry``/``cache``), or a value pinned back to one
  (``v.to(<carry>.dtype)``, ``v.to(dtype=<carry>.dtype)``,
  ``v.type_as(<carry>)``, ``v.to(<carry>)``);
* ``DRIFT`` — a carry-derived value cast to a *non-carry* dtype
  (``state.to(x.dtype)``, ``state.to(dtype=x.dtype)``,
  ``state.type_as(x)``, ``state.to(x)``), propagated through
  dtype-preserving ops (``torch.cat``/``concat``/``stack``/``where``/
  ``F.pad``/…, method forms such as ``.reshape()``/``.clone()``, in-place
  writes, subscripts, arithmetic); a move to another device
  (``.to("cuda")``, ``.to(x.device)``) keeps the value's status;
* ``OTHER`` — everything else, including explicit literal casts
  (``.float()``, ``.bfloat16()``, ``.to(torch.float32)``: the author
  pinned a concrete dtype on purpose) and calls the lattice does not model.

Returning a ``DRIFT`` value is the hazard: the fix is
``new_state.to(state.dtype)`` (pin to the init dtype) before the return.
Fix-only policy, like DLK001: drift findings must be fixed or
pragma-justified, never baselined.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       qualname, register)

OTHER, CARRY, DRIFT = 0, 1, 2

#: parameter-name fragments that mark carried state
CARRYISH = ("state", "carry", "cache")

#: ops that keep their (widest) input dtype — drift flows through them,
#: in function form (``torch.cat(xs)``) and in method form (``x.flip(1)``)
_PRESERVING = {"cat", "concat", "concatenate", "stack", "hstack", "vstack",
               "where", "pad", "roll", "flip", "maximum", "minimum", "clamp",
               "clip", "reshape", "view", "transpose", "permute", "expand",
               "expand_as", "broadcast_to", "squeeze", "unsqueeze",
               "flatten", "unflatten", "narrow", "select", "contiguous",
               "clone", "detach", "repeat", "tile", "index_select", "gather",
               "masked_fill", "index_copy", "scatter", "movedim", "split",
               "chunk", "unbind", "new_zeros", "zeros_like", "empty_like"}

#: in-place writes: the result is the receiver, in the receiver's dtype
_IN_PLACE = {"copy_", "index_copy_", "index_put_", "scatter_", "masked_fill_",
             "mul_", "add_", "sub_", "div_", "zero_", "fill_", "clamp_"}

#: methods that cast to a fixed dtype
_LITERAL_CASTS = {"float", "double", "half", "bfloat16", "int", "long",
                  "short", "bool", "byte", "char"}


def _carry_params(fn: ast.FunctionDef):
    args = fn.args
    return {a.arg for a in args.posonlyargs + args.args
            if a.arg not in ("self", "cls")
            and any(t in a.arg.lower() for t in CARRYISH)}


def _is_literal_dtype(node) -> bool:
    """``torch.float32`` / ``torch.bfloat16`` / ``np.dtype("f4")`` — an
    explicit concrete dtype, not one borrowed from another tensor."""
    qn = qualname(node.func if isinstance(node, ast.Call) else node)
    leaf = qn.rsplit(".", 1)[-1] if qn else ""
    return leaf.startswith(("float", "bfloat", "int", "uint", "bool",
                            "complex", "dtype", "half", "double", "long"))


def _is_device(node) -> bool:
    """A device, not a dtype: ``"cuda"``, ``torch.device(...)``,
    ``x.device``, or a name that says it is one (``dev``, ``device``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.Call):
        return qualname(node.func) in ("torch.device", "device")
    if isinstance(node, ast.Attribute):
        return node.attr == "device"
    return isinstance(node, ast.Name) and node.id.lower() in (
        "dev", "device", "gpu", "cpu", "cuda")


def _cast_target(call: ast.Call) -> Optional[ast.expr]:
    """The dtype source of a ``.to(...)`` call, or None for a move to a
    device that keeps the dtype: ``.to(dtype)``, ``.to(dtype=dtype)``,
    ``.to(device, dtype)``, ``.to(other)``."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    args = [a for a in call.args if not _is_device(a)]
    return args[0] if args else None


class _Lattice:
    def __init__(self, env: Dict[str, int]):
        self.env = env

    def eval(self, node) -> int:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, OTHER)
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self.eval(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.BinOp):
            # promotion keeps the widest dtype; mixing a carry into
            # arithmetic is not (by itself) a drift
            return max(self.eval(node.left), self.eval(node.right))
        if isinstance(node, ast.IfExp):
            return max(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return max((self.eval(e) for e in node.elts), default=OTHER)
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        return OTHER

    def _cast(self, receiver, target) -> int:
        """``receiver`` cast to the dtype of ``target`` (a ``.dtype``
        attribute, a dtype name, or a tensor whose dtype is borrowed)."""
        if isinstance(target, ast.Attribute) and target.attr == "dtype":
            if self.eval(target.value) == CARRY:
                return CARRY            # pinned back to the carry dtype
            if self.eval(receiver) in (CARRY, DRIFT):
                return DRIFT            # carry cast to a foreign dtype
            return OTHER
        if _is_literal_dtype(target):
            return OTHER                # concrete dtype chosen on purpose
        if isinstance(target, ast.Name) \
                and self.env.get(target.id, OTHER) == CARRY:
            return CARRY                # dt = state.dtype; v.to(dt)
        if self.eval(receiver) in (CARRY, DRIFT):
            return DRIFT
        return OTHER

    def _eval_call(self, call: ast.Call) -> int:
        f = call.func
        if isinstance(f, ast.Attribute):
            if f.attr == "to":
                target = _cast_target(call)
                if target is None:
                    return self.eval(f.value)   # a device move
                return self._cast(f.value, target)
            if f.attr == "type_as" and call.args:
                return self._cast(f.value, call.args[0])
            if f.attr in _LITERAL_CASTS and not call.args:
                return OTHER
            if f.attr in _IN_PLACE:
                return self.eval(f.value)
        qn = qualname(f)
        leaf = f.attr if isinstance(f, ast.Attribute) \
            else (qn.rsplit(".", 1)[-1] if qn else "")
        if leaf in _PRESERVING:
            status = max((self.eval(a) for a in call.args), default=OTHER)
            if isinstance(f, ast.Attribute):
                status = max(status, self.eval(f.value))
            return max(status,
                       max((self.eval(kw.value) for kw in call.keywords
                            if kw.arg != "dtype"), default=OTHER))
        return OTHER


@register
class DtypeDrift(Rule):
    """Carry returned in a drifted dtype — a new step signature."""

    code = "DLK010"
    name = "dtype-drift"
    skip_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ctx.functions:
            carry = _carry_params(fn)
            if not carry:
                continue
            env = {p: CARRY for p in carry}
            lat = _Lattice(env)
            assigns = sorted(
                (n for n in ast.walk(fn)
                 if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
                 and ctx.enclosing_function(n) is fn),
                key=lambda n: (n.lineno, n.col_offset))
            for node in assigns:
                if isinstance(node, ast.AugAssign):
                    if isinstance(node.target, ast.Name):
                        env[node.target.id] = max(
                            env.get(node.target.id, OTHER),
                            lat.eval(node.value))
                    continue
                value = node.value
                if value is None:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if isinstance(tgt, (ast.Tuple, ast.List)) \
                            and isinstance(value, (ast.Tuple, ast.List)) \
                            and len(tgt.elts) == len(value.elts):
                        for t, v in zip(tgt.elts, value.elts):
                            if isinstance(t, ast.Name):
                                env[t.id] = lat.eval(v)
                    else:
                        status = lat.eval(value)
                        elts = tgt.elts if isinstance(
                            tgt, (ast.Tuple, ast.List)) else [tgt]
                        for t in elts:
                            if isinstance(t, ast.Name):
                                env[t.id] = status
            for node in ast.walk(fn):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                if ctx.enclosing_function(node) is not fn:
                    continue
                v = node.value
                elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
                for e in elts:
                    if lat.eval(e) != DRIFT:
                        continue
                    # only the carried slot of the return is the hazard: a
                    # drift-derived *activation* (e.g. `out = xp * w`) has a
                    # stable dtype and never feeds the next step's carry
                    if isinstance(e, ast.Name) and not any(
                            t in e.id.lower() for t in CARRYISH):
                        continue
                    label = e.id if isinstance(e, ast.Name) \
                        else "a carry value"
                    yield ctx.finding(
                        self, node,
                        f"'{fn.name}' returns {label} cast to a "
                        "non-carry dtype (via .to(<activation>.dtype)) — "
                        "the carried state's signature changes on the next "
                        "step, which counts a new compile (and would "
                        "recapture a graph); pin it with "
                        ".to(<carry>.dtype) before returning")
                    break
