"""Collectives that carry a gradient.

``torch.distributed``'s collectives have no autograd, so each one the
model runs under a gradient is a ``torch.autograd.Function`` whose backward
is its adjoint, on the convention that the ranks' losses add up to the
global one: the backward of an all-to-all is the reverse all-to-all, that
of an all-gather is the rank's slice of a sum over the group, and that of
a mean over the group is the mean of the gradients. Each rank then holds a
partial gradient of every weight it used, and the train step sums them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_to_all(x, group):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=0)[dist.get_rank(ctx.group)], None


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Block ``j`` of ``x``'s leading dim (of the group's size) goes to
    rank ``j``; block ``i`` of the result came from rank ``i``."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0, in rank order."""
    return _AllGather.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group."""
    return _AllReduceMean.apply(x, group)

