"""Train step: bf16 compute, f32 master params and optimizer, microbatched
gradient accumulation, remat (the model's per-layer checkpoint).

A Python loop over microbatches takes the place of the reference's
``lax.scan``; gradients are taken with ``torch.autograd.grad`` with respect
to detached views of the parameters (so the state's tensors never carry
``requires_grad``), accumulated in f32 and divided by the microbatch count.

The reference's sharding-spec helpers (``batch_specs``, ``param_specs``,
``state_specs``, ``shardings``) are here spec for spec, and
:class:`ShardedTrainStep` is the step on a DeviceMesh whose result is the
one-process step's on the same mesh shape, run as the reference's layout
runs under GSPMD: the state at rest is each rank's block of every leaf,
each layer gathers its own leaves where it runs (``Sharder.use``: a rank
holds one layer at a time) and computes its share of the heads, the MLP
width, the recurrent layers' inner channels and the vocabulary over
``model`` (Megatron-style), the gathers' backward reduce-scatters each microbatch's gradients to the rank's
blocks, the blocks are summed over the ranks that hold them alike, and
AdamW updates each rank's own blocks. MoE layers may run expert
parallelism over ``model`` (``moe_impl="shard_map"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import loops
from repro_torch.models.common import chunked_softmax_xent, softmax_xent
from repro_torch.models.registry import abstract_params
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (NamedSharding, P, PartitionSpec,
                                           mesh_shape, spec_axes, spec_for,
                                           tree_specs)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import (OptConfig, OptState, tree_leaves,
                                         tree_map)


class TrainState(NamedTuple):
    params: dict
    opt: OptState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    num_microbatches: int = 1
    aux_loss_weight: float = 0.01
    label_ignore: int = -1
    # cast f32 master params to bf16 ONCE per step (outside the microbatch
    # loop); grads are taken w.r.t. the bf16 tree and accumulated in f32
    # (the standard bf16-param/f32-master scheme)
    cast_params_once: bool = False
    # >1: chunked cross-entropy (never materializes [B,S,V] logits);
    # requires the model to expose .hidden()
    vocab_chunks: int = 1


@dataclasses.dataclass
class RankShare:
    """How one rank's loss adds up to the global one: its rows are one of
    ``batch_shards`` blocks of the global batch, each held by ``replicas``
    ranks (the ``model`` ranks of a row block, whether they split its
    compute or repeat it). The ranks' losses sum to the global loss, so
    their gradients sum to its gradient: the cross-entropy, a mean over
    the valid tokens, is the rank's mean weighted by its share of the
    global valid count (an all-reduce), and the aux term (a mean over
    groups) counts 1 / ``batch_shards``; both are divided among the
    replicas. Every collective's backward is its adjoint under this sum
    (``parallel.comm``), so a weight's gradient is the sum of the ranks'
    partial ones, held or not."""

    batch_shards: int = 1
    replicas: int = 1
    group: object = None

    def rank_loss(self, xent, mask, aux_term):
        local = mask.sum()
        total = comm.all_reduce(local.clone(), self.group)
        total = total / self.replicas
        return (xent * (local / total.clamp_min(1.0))
                + aux_term / self.batch_shards) / self.replicas


def make_loss_fn(model, step_cfg: StepConfig, share: RankShare = None):
    """The loss of a microbatch; with ``share``, one rank's part of the
    global microbatch's loss."""
    def total(xent, mask, aux):
        if share is None:
            return xent + step_cfg.aux_loss_weight * aux
        return share.rank_loss(xent, mask, step_cfg.aux_loss_weight * aux)

    if step_cfg.vocab_chunks > 1 and hasattr(model, "hidden"):
        def loss_fn(params, mb):
            h, aux = model.hidden(params, mb)
            labels = mb["labels"]
            h = h[:, -labels.shape[1]:]
            mask = (labels != step_cfg.label_ignore).float()
            loss = chunked_softmax_xent(
                h, model.head(params), labels.clamp_min(0), mask,
                step_cfg.vocab_chunks, model.shd.tp, model.cfg.vocab_size)
            return total(loss, mask, aux)
        return loss_fn

    def loss_fn(params, mb):
        logits, aux = model.forward(params, mb)
        labels = mb["labels"]
        logits = logits[:, -labels.shape[1]:]
        mask = (labels != step_cfg.label_ignore).float()
        loss = softmax_xent(logits, labels.clamp_min(0), mask, model.shd.tp,
                            model.cfg.vocab_size)
        return total(loss, mask, aux)
    return loss_fn


def make_grad_fn(model, step_cfg: StepConfig, share: RankShare = None):
    """Returns grad_fn(params, batch) -> (loss, f32 grads): the train
    step's loss and gradients before the optimizer, microbatched (with
    ``share``, one rank's part of them: ``RankShare``)."""
    loss_fn = make_loss_fn(model, step_cfg, share)
    n_micro = step_cfg.num_microbatches

    def grad_fn(params, batch):
        if step_cfg.cast_params_once:
            params = tree_map(
                lambda p: p.detach().to(torch.bfloat16)
                if p.dtype == torch.float32 and p.dim() > 1 else p.detach(),
                params)
        else:
            params = tree_map(torch.Tensor.detach, params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_()
        if batch["tokens"].shape[0] % n_micro:
            raise ValueError(f"batch {batch['tokens'].shape[0]} is not a "
                             f"multiple of {n_micro} microbatches")
        size = batch["tokens"].shape[0] // n_micro
        loss = gacc = None
        # the microbatches have one shape: a dry-run runs the first two
        # (core.loops.trips)
        for i in loops.trips(n_micro):
            mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            lm = loss_fn(params, mb)
            grads = [g.float() for g in torch.autograd.grad(lm, leaves)]
            lm = lm.detach()
            if gacc is None:
                loss, gacc = lm, grads
            else:
                loss = loss + lm
                for a, g in zip(gacc, grads):
                    a.add_(g)
                del g
            # this trip's gradients go before the next trip makes its own
            del grads
        if n_micro > 1:
            loss = loss / n_micro
            for a in gacc:
                a.div_(n_micro)
        it = iter(gacc)
        return loss, tree_map(lambda _: next(it), params)

    return grad_fn


def make_train_step(model, opt_cfg: OptConfig, step_cfg: StepConfig):
    """Returns train_step(state, batch) -> (state, metrics). The state's
    parameters and moments are updated in place (see
    ``repro_torch.train.optimizer``); metrics stay on the device."""
    grad_fn = make_grad_fn(model, step_cfg)

    def train_step(state: TrainState, batch):
        loss, grads = grad_fn(state.params, batch)
        new_params, new_opt, metrics = opt_mod.adamw_update(
            opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# sharding specs, and the train step on a DeviceMesh


def batch_specs(mesh, batch_sds, rules=None):
    """Shard the leading (batch) dim of every input over ("pod","data")."""
    return {k: spec_for(mesh, ("batch",) + (None,) * (len(x.shape) - 1),
                        tuple(x.shape), rules)
            for k, x in batch_sds.items()}


def param_specs(mesh, params_sds, axes, rules=None):
    """PartitionSpecs of a parameter tree from its logical axes
    (``abstract_params``) and shapes."""
    return tree_specs(mesh, axes, params_sds, rules)


def state_specs(mesh, params_sds, axes, rules=None):
    ps = param_specs(mesh, params_sds, axes, rules)
    return TrainState(params=ps, opt=OptState(m=ps, v=ps, step=P()))


def _spec_map(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    return type(tree)(*(_spec_map(fn, v) for v in tree))


def shardings(mesh, spec_tree):
    """A ``NamedSharding`` for each spec of ``spec_tree``."""
    return _spec_map(lambda s: NamedSharding(mesh, s), spec_tree)


class ShardedTrainStep:
    """The train step on a DeviceMesh over the whole process group, or on
    a ``launch.mesh.RankMesh`` (one rank's step with stand-in collectives:
    the dry-run's, on meta tensors).

    ``layout`` cuts a full state into the rank's blocks (``state_specs``:
    ``m`` and ``v`` follow their parameter), ``gather`` puts full leaves
    back together (the checkpoint's), and a call takes the blocks and the
    GLOBAL batch (every rank the same) and returns the updated blocks and
    the global loss and grad norm. The rank's rows of microbatch ``i`` are
    its block of that microbatch, so the microbatches hold the rows they
    hold in the one-process step; the MoE routing groups follow the
    global microbatch's batch spec (``Sharder.rank_batch``).

    The model runs on the blocks (``Sharder.rank_blocks``): each layer
    gathers its leaves at use and its backward reduce-scatters their
    gradients over the same axes, microbatch by microbatch, so the
    accumulated gradients are blocks too. After the last microbatch each
    block is summed over the mesh axes its spec does not split (the ranks
    that hold it alike: the pod axis, and ``model`` for a leaf whose
    compute runs whole on every ``model`` rank). At one rank every
    collective is the identity and the step is the one-process step bit
    for bit."""

    def __init__(self, model, opt_cfg: OptConfig, step_cfg: StepConfig,
                 mesh, rules=None):
        self.model, self.opt_cfg, self.step_cfg = model, opt_cfg, step_cfg
        self.mesh, self.rules = mesh, rules
        shapes, self.axes = abstract_params(model)
        self.shardings = shardings(mesh, state_specs(mesh, shapes,
                                                     self.axes, rules))
        self.specs = tree_map(lambda s: s.spec, self.shardings.params)
        self.replicas = tree_map(lambda s: s.replicas,
                                 self.shardings.params)
        self.group = comm.world_group(mesh)
        self.share = RankShare(group=self.group)
        self.grad_fn = make_grad_fn(model, step_cfg, self.share)

    def layout(self, state: TrainState) -> TrainState:
        """The rank's blocks of a full state (each full leaf is dropped as
        its block is cut)."""
        def cut(tree, sh):
            for k in list(tree):
                if isinstance(tree[k], dict):
                    cut(tree[k], sh[k])
                else:
                    tree[k] = sh[k].block(tree[k])
        lay = self.shardings.params
        for tree in (state.params, state.opt.m, state.opt.v):
            cut(tree, lay)
        return state

    def gather(self, state: TrainState) -> TrainState:
        """The full state from every rank's blocks (a collective)."""
        lay = self.shardings.params
        full = lambda tree: tree_map(lambda b, sh: sh.gather(b), tree, lay)
        return TrainState(full(state.params),
                          OptState(full(state.opt.m), full(state.opt.v),
                                   state.opt.step))

    def rank_rows(self, batch):
        """(the rank's rows of each microbatch, in order; the mesh axes the
        global microbatch is split over)."""
        n_micro = self.step_cfg.num_microbatches
        rows = batch["tokens"].shape[0]
        if rows % n_micro:
            raise ValueError(f"batch {rows} is not a multiple of {n_micro} "
                             "microbatches")
        size = rows // n_micro
        spec = spec_for(self.mesh, ("batch",), (size,), self.rules)
        split = NamedSharding(self.mesh, spec)
        out = {}
        for k, x in batch.items():
            x = torch.as_tensor(x)
            out[k] = torch.cat([split.block(x[i * size:(i + 1) * size])
                                for i in range(n_micro)])
        return out, spec_axes(spec[0]) if len(spec) else ()

    def _sum_replicas(self, g, spec):
        """Sum a gradient block over the mesh axes ``spec`` does not split,
        in place, one axis at a time."""
        split = {a for e in spec for a in spec_axes(e)}
        for a, n in mesh_shape(self.mesh).items():
            if n > 1 and a not in split:
                comm.all_reduce(g, self.mesh.get_group(a))
        return g

    def grads(self, state: TrainState, batch):
        """(the global loss, the rank's blocks of the global gradient):
        the step before the optimizer."""
        rows, axes = self.rank_rows(batch)
        sizes = mesh_shape(self.mesh)
        self.share.batch_shards = math.prod(sizes[a] for a in axes)
        self.share.replicas = math.prod(sizes.values()) \
            // self.share.batch_shards
        shd = self.model.shd
        with shd.rank_batch(axes), shd.rank_blocks(self.specs, self.axes):
            loss, grads = self.grad_fn(state.params, rows)
        comm.all_reduce(loss, self.group)
        return loss, tree_map(self._sum_replicas, grads, self.specs)

    def apply(self, state: TrainState, loss, grads):
        """AdamW on the rank's blocks with the gradient blocks ``grads``
        (spent); (state, metrics)."""
        new_params, new_opt, metrics = opt_mod.adamw_update(
            self.opt_cfg, state.params, grads, state.opt,
            replicas=self.replicas, group=self.group)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt), metrics

    def __call__(self, state: TrainState, batch):
        return self.apply(state, *self.grads(state, batch))
