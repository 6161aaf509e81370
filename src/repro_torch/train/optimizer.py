"""AdamW + schedules over dicts of tensors, in f32.

The update is the reference's (``repro.train.optimizer``): global-norm
clip, bias-corrected moments, decoupled weight decay. It works in place on
the parameters and moments it is given, as the reference's launcher
donates the train state (``donate_argnums=(0,)``): a functional update
would hold the old and the new parameters and moments at once, 12 bytes a
parameter more, which a model at full width cannot spare on one card. The
step counter, the learning rate, the clip scale and the norm stay on the
device, so an update never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch

from repro_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = ((step - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    """Zero f32 moments beside each parameter, step 0 on their device."""
    leaf = tree_leaves(params)[0]
    return OptState(
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        step=torch.zeros((), dtype=torch.int32, device=leaf.device))


def abstract_opt_state(params_sds) -> OptState:
    """The optimizer state of a parameter shape tree (``abstract_params``'
    shapes, or tensors) on the meta device: f32 ``m`` and ``v`` of each
    parameter's shape and the int32 step; nothing is allocated."""
    def f32(p):
        shape = p.shape if hasattr(p, "shape") else p
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    return OptState(m=tree_map(f32, params_sds), v=tree_map(f32, params_sds),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


def global_norm(tree, replicas=None, group=None) -> torch.Tensor:
    """The L2 norm over every leaf. With ``replicas`` (a matching tree of
    ints) the leaves are each rank's blocks of a gradient spread over the
    process group (``group``: None for the default one, or a stand-in),
    each block held by that many ranks: the squares of a block count once
    over its holders, and the sum is all-reduced."""
    reps = [1] * len(tree_leaves(tree)) if replicas is None else \
        tree_leaves(replicas)
    total = None
    for g, r in zip(tree_leaves(tree), reps):
        sq = g.float().square().sum()
        if replicas is not None:
            sq = sq / r
        total = sq if total is None else total + sq
    if replicas is not None:
        comm.all_reduce(total, group)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state: OptState,
                 replicas=None, group=None):
    """Returns (params, state, metrics): ``params`` and the moments updated
    in place; ``grads`` (f32) are scaled in place by the clip and spent.
    ``params``, ``grads`` and the moments may be each rank's blocks of a
    sharded state: ``replicas`` (and ``group``) then make the clip see the
    whole gradient's norm (``global_norm``)."""
    gnorm = global_norm(grads, replicas, group)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float().mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        pf = p.float()
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(pf, alpha=cfg.weight_decay)
        pf.sub_(delta.mul_(lr))
        if pf is not p:
            p.copy_(pf)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        upd(p, g, m, v)
    metrics: Dict[str, torch.Tensor] = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.m, state.v, step), metrics
