"""Loops whose trips have one shape, and the counter that may scale them.

``trips`` and ``scan`` run every trip of a loop, unless an op counter
that scales loops is running (``perf.op_cost.OpCounter(scale_loops=True)``,
the dry-run's): then they run only the trips that differ and have the
counter count each as the trips it stands for, as the reference's
``hlo_cost`` multiplies a while body by its trip count. The counter
registers itself here (``enter``, ``leave``), so the model and parallel
code that runs such loops, or reports a stand-in collective to it
(``parallel.comm.ShapeGroup``), need not know the perf layer.

What the counter offers: ``scale_loops``; ``scaled(n)`` (count the ops
inside ``n`` times over), ``pause()`` (run ops without counting them),
``hold(n_bytes)`` (a meta block it counts as live), ``live_bytes``; and
``collective(op, result_bytes, group_size, crosses_pod)``.

``trips`` suits a loop whose body stands alone (the train step's
microbatches: the first trip creates the accumulator, the others add into
it, so trips 0 and 1 run and trip 1 counts ``n - 1`` times; its peak is
every later trip's). ``scan`` suits a carried loop (the sLSTM's tokens,
the mLSTM's and SSD's chunks): without a gradient trip 0 counts ``n``
times and the other trips' outputs are filled in with storage of their
size, and the scaled count equals the unscaled one exactly. Under a
gradient trip 0 runs as it is (its carry takes no gradient) and trip 1
runs in an autograd Function whose forward and backward count ``n - 1``
times, holding a meta block of the bytes the skipped trips would keep for
their backward: the FLOPs are exact; the bytes leave out the autograd
engine's sums of the gradients each trip's carry receives from the next
trip, and count the last trip's backward as a middle one's.
"""
from __future__ import annotations

from typing import List

import torch

#: the counters entered and not yet left, innermost last
_counters: List[object] = []


def enter(counter):
    _counters.append(counter)


def leave(counter):
    _counters.remove(counter)


def counter():
    """The innermost op counter running, or None."""
    return _counters[-1] if _counters else None


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _scaling(n: int):
    c = counter()
    return c if c is not None and c.scale_loops and n > 2 else None


def trips(n: int):
    """``range(n)`` for a loop whose trips have the same shapes and whose
    first trip differs from the rest (it starts what the others add to).
    Under a counter that scales loops: trips 0 and 1, the second counted
    ``n - 1`` times."""
    c = _scaling(n)
    if c is None:
        yield from range(n)
        return
    yield 0
    with c.scaled(n - 1):
        yield 1


class _Trip(torch.autograd.Function):
    """One trip of a scaled ``scan`` under a gradient, standing for ``n``:
    the body's forward and backward each counted ``n`` times; the bytes
    the ``n - 1`` skipped trips would keep for the backward are held as
    one meta block until then."""

    @staticmethod
    def forward(ctx, counter, n, body, n_carry, *tensors):
        ins = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
        before = counter.live_bytes
        with torch.enable_grad(), counter.scaled(n):
            carry, y = body(tuple(ins[:n_carry]), *ins[n_carry:])
        outs = tuple(carry) + (y,)
        ctx.block = counter.hold((n - 1) * (counter.live_bytes - before))
        ctx.graph, ctx.counter, ctx.n = (ins, outs), counter, n
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ins, outs = ctx.graph
        need = [t for t in ins if t.requires_grad]
        with ctx.counter.scaled(ctx.n):
            got = iter(torch.autograd.grad(outs, need, grads,
                                           allow_unused=True))
        ctx.graph = ctx.block = None
        return (None,) * 4 + tuple(next(got) if t.requires_grad else None
                                   for t in ins)


def scan(body, carry: tuple, xs, consts: tuple = (), *,
         scale_grad: bool = True):
    """``lax.scan`` over ``xs`` (a sequence of tensors, or of tuples of
    tensors, of one shape): ``carry, y = body(carry, x, *consts)`` for
    each x in turn; returns (carry, [y, ...]). Under a counter that scales
    loops trip 0 runs alone, counted ``len(xs)`` times (see the module
    docstring); under a gradient only with ``scale_grad`` (False inside a
    remat block, whose recompute reruns the loop)."""
    n = len(xs)
    c = _scaling(n)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors((carry, xs[0], consts)))
    if c is None or (grad and not scale_grad):
        ys = []
        for x in xs:
            carry, y = body(carry, x, *consts)
            ys.append(y)
        return carry, ys
    if grad:
        # trip 0's carry takes no gradient (it is the initial state), the
        # others' do: trip 0 runs as it is, trip 1 stands for the rest
        carry, y0 = body(carry, xs[0], *consts)
        tensors = tuple(carry) + (xs[1],) + tuple(consts)
        *carry, y = _Trip.apply(c, n - 1, body, len(carry), *tensors)
        with c.pause():
            # the skipped trips' outputs, outside the graph (each trip's
            # own output takes its own gradient): their storage is in
            # _Trip's block
            rest = y.detach().expand((n - 2,) + tuple(y.shape)).unbind(0)
        return tuple(carry), [y0, y, *rest]
    with c.scaled(n):
        carry, y = body(carry, xs[0], *consts)
    with c.pause():
        rest = y.new_empty((n - 1,) + tuple(y.shape)).unbind(0)
    return carry, [y, *rest]
