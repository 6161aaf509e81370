"""DLK008 state-reset-pairing.

Releasing a serving slot recycles its index for the next request, but
the backend state the slot owned — KV pages, a ring row, carried
recurrent state — lives in the adapter, not the ``SlotManager``. A
``slots.release(slot)`` with no adapter reset/free on the prior
occupant leaks that state into the next request: for paged KV the
pages pin forever, for recurrent families the new prompt *continues
the previous conversation's hidden state*, which is silent output
corruption rather than a crash. The rule is lexical: a ``release``
call on a slot-manager-shaped receiver must be preceded, in the same
function, by an adapter-side reset/free call (``free_slot``,
``release_slot``, ``reset_slot``, ``reset_cache_slot``, ``free``, or
``reset``). ``self.release`` (the manager's own implementation) is
exempt, same as DLK006's ``self.alloc`` carve-out.

Policy mirrors DLK001: findings are *fixed*, never baselined — pairing
the release is a one-line fix and grandfathering it would grandfather
cross-request state leakage.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       qualname, register)

#: adapter-side calls that scrub a slot's backend state before reuse
_RESETISH = ("free_slot", "release_slot", "reset_slot", "reset_cache_slot",
             "free", "reset")


def _slot_receiver(func) -> Optional[str]:
    """Receiver text if this is ``<slots>.release`` on something
    slot-manager-shaped. ``self.release`` (the manager's own method) is
    exempt — the manager resets its *own* bookkeeping there; the pairing
    obligation is on the caller that owns the adapter."""
    if not isinstance(func, ast.Attribute) or func.attr != "release":
        return None
    recv = qualname(func.value)
    if not recv or recv == "self":
        return None
    probe = recv[5:] if recv.startswith("self.") else recv
    if "slot" in probe.lower():
        return recv
    return None


@register
class StateResetPairing(Rule):
    """Slot released for reuse without adapter reset/free of its state."""

    code = "DLK008"
    name = "state-reset-pairing"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            recv = _slot_receiver(node.func)
            if recv is None:
                continue
            fn = ctx.enclosing_function(node)
            scope = fn if fn is not None else ctx.tree
            paired = any(
                isinstance(prior, ast.Call)
                and isinstance(prior.func, ast.Attribute)
                and prior.func.attr in _RESETISH
                and prior.lineno <= node.lineno
                for prior in ast.walk(scope))
            if not paired:
                yield ctx.finding(
                    self, node,
                    f"{recv}.release(...) recycles the slot without an "
                    "adapter reset/free of the prior occupant's state — "
                    "the next request inherits its pages/ring/recurrent "
                    "state (call free_slot/reset_cache_slot first)")
