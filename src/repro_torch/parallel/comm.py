"""Collectives that carry a gradient, and their shape-only stand-ins.

``torch.distributed``'s collectives have no autograd, so each one the
model runs under a gradient is a ``torch.autograd.Function`` whose backward
is its adjoint, on the convention that the ranks' losses add up to the
global one: the backward of an all-to-all is the reverse all-to-all, that
of an all-gather is a reduce-scatter (and the reverse), that of a sum over
the group is another sum, and that of a mean over the group is the mean of
the gradients. Each rank then holds a partial gradient of every weight it
used, and the train step sums them.

Megatron's two operators over a tensor-parallel group (``f``: identity
forward, all-reduce backward; ``g``: all-reduce forward, identity
backward) assume that each rank's loss is the whole loss. Under the
convention above a sum over the group is both at once,
:func:`all_reduce_sum`: its forward and its backward each sum once.

A group is a ``torch.distributed`` process group (None: the default one),
a DeviceMesh axis's (``mesh.get_group(axis)``) or a stand-in.

A :class:`ShapeGroup` (a ``launch.mesh.RankMesh``'s group: one rank's view
of a mesh with no process group) stands in for a process group: each
collective on it allocates what the real one allocates, moves no data,
and is reported to the running op counter (``core.loops.counter``) with
its result's bytes and the group's size. The dry-run runs a rank's step
on such groups, on meta tensors; at one rank each collective is the
identity, as the real one is, on any tensor.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core import loops


class ShapeGroup:
    """The ranks along ``axes`` of a stand-in mesh (sizes ``sizes``) seen
    from its rank 0. Above one rank its collectives take meta tensors
    only: on real ones their results would be garbage."""

    rank = 0

    def __init__(self, sizes: dict, axes):
        self.axes = tuple(axes)
        self.size = math.prod(sizes[a] for a in self.axes)
        self.crosses_pod = "pod" in self.axes and sizes["pod"] > 1

    def _report(self, op: str, x: torch.Tensor, result: torch.Tensor):
        if self.size > 1 and x.device.type != "meta":
            raise RuntimeError(
                f"a stand-in {op} over {self.size} ranks moves no data: it "
                f"takes meta tensors only, not {x.device} ones")
        c = loops.counter()
        if c is not None:
            c.collective(op, result.numel() * result.element_size(),
                         self.size, self.crosses_pod)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self._report("all-reduce", t, t)
        return t

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        self._report("all-gather", x, out)
        if self.size == 1:
            out.copy_(x)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        self._report("reduce-scatter", x, out)
        if self.size == 1:
            out.copy_(x)
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        self._report("all-reduce", t, t)
        return t

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        self._report("all-to-all", x, out)
        if self.size == 1:
            out.copy_(x)
        return out


# the names torch 2.13 gives the single-tensor collectives, else 2.11's
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


class _ProcessGroup:
    """``torch.distributed``'s collectives on ``group`` (None: the default
    process group)."""

    def __init__(self, group):
        self.group = group

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(out, x.contiguous(), group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        _reduce_scatter_single(out, x.contiguous(), group=self.group)
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        return out


def _on(group):
    """The collectives of ``group``: a stand-in's own, else
    ``torch.distributed``'s."""
    return group if isinstance(group, ShapeGroup) else _ProcessGroup(group)


def world_group(mesh):
    """The group of every rank of ``mesh``: a ``RankMesh``'s stand-in (its
    ``world``), else None (the default process group, which a DeviceMesh
    spans)."""
    return getattr(mesh, "world", None)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group in place (no gradient)."""
    return _on(group).all_reduce(t)


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over the group, in place (no
    gradient)."""
    return _on(group).all_reduce_max(t)


def _along(fn, x, dim):
    """``fn`` (a collective along dim 0) along ``dim`` of ``x``."""
    if dim == 0:
        return fn(x)
    return fn(x.movedim(dim, 0).contiguous()).movedim(0, dim).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.ops = _on(group)
        return ctx.ops.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ops.all_to_all(g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.ops, ctx.dim = _on(group), dim
        return _along(ctx.ops.all_gather, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _along(ctx.ops.reduce_scatter, g, ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.ops = _on(group)
        return ctx.ops.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.ops.all_reduce(g.clone()), None


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.ops = _on(group)
        return ctx.ops.all_reduce(x.clone()) / ctx.ops.size

    @staticmethod
    def backward(ctx, g):
        return ctx.ops.all_reduce(g.clone()) / ctx.ops.size, None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Block ``j`` of ``x``'s leading dim (of the group's size) goes to
    rank ``j``; block ``i`` of the result came from rank ``i``."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim``, in rank order; its
    backward reduce-scatters the gradient back to the rank's block."""
    return _AllGather.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group, whose backward sums the gradient
    over the group: the adjoint when the ranks' losses add up to the
    global one (a row-parallel product's partial outputs, a vocab-parallel
    lookup or softmax sum)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group."""
    return _AllReduceMean.apply(x, group)


def softmax_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Attention over keys split among the group's ranks (flash-decoding's
    combine), from each rank's partial over its block of keys
    (``models.common.partial_attention``): per query row and head the
    block's max score ``m``, ``l`` the sum of ``exp(s - m)`` and ``o``
    [..., D] the sum of ``exp(s - m) v``, masked scores at ``NEG_INF``.
    The max over the ranks (no gradient: any shift gives the same
    quotient) rescales each rank's ``l`` and ``o``, one all-reduce sums
    both, and their quotient is the unsplit attention. A block with no
    valid key for a row has ``m`` = ``NEG_INF``: where another rank holds
    one, its scale ``exp(NEG_INF - max)`` is exactly 0 (never ``-inf -
    -inf``, never NaN) and it adds nothing; where no rank does, every
    scale is 1 and the row is the mean of the values over all keys, as the
    unsplit softmax over ``NEG_INF`` scores has it. The rank holding the
    max has ``l`` >= 1, so the quotient is finite."""
    mx = all_reduce_max(m.detach().clone(), group)
    a = torch.exp(m - mx)
    lo = all_reduce_sum(torch.cat([o * a[..., None], (l * a)[..., None]],
                                  dim=-1), group)
    return lo[..., :-1] / lo[..., -1:]
