"""Train step: bf16 compute, f32 master params and optimizer, microbatched
gradient accumulation, remat (the model's per-layer checkpoint).

A Python loop over microbatches takes the place of the reference's
``lax.scan``; gradients are taken with ``torch.autograd.grad`` with respect
to detached views of the parameters (so the state's tensors never carry
``requires_grad``), accumulated in f32 and divided by the microbatch count.
The sharding-spec helpers of the reference (``batch_specs``,
``param_specs``, ``state_specs``, ``shardings``) wait for the port's
parallelism slice: this step runs on one device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.common import chunked_softmax_xent, softmax_xent
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


def make_loss_fn(model, step_cfg: StepConfig):
    if step_cfg.vocab_chunks > 1 and hasattr(model, "hidden"):
        def loss_fn(params, mb):
            h, aux = model.hidden(params, mb)
            labels = mb["labels"]
            h = h[:, -labels.shape[1]:]
            mask = (labels != step_cfg.label_ignore).float()
            loss = chunked_softmax_xent(h, params, labels.clamp_min(0),
                                        mask, step_cfg.vocab_chunks)
            return loss + step_cfg.aux_loss_weight * aux
        return loss_fn

    def loss_fn(params, mb):
        logits, aux = model.forward(params, mb)
        labels = mb["labels"]
        logits = logits[:, -labels.shape[1]:]
        mask = (labels != step_cfg.label_ignore).float()
        loss = softmax_xent(logits, labels.clamp_min(0), mask)
        return loss + step_cfg.aux_loss_weight * aux
    return loss_fn


def make_grad_fn(model, step_cfg: StepConfig):
    """Returns grad_fn(params, batch) -> (loss, f32 grads): the train
    step's loss and gradients before the optimizer, microbatched."""
    loss_fn = make_loss_fn(model, step_cfg)
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
        for i in range(n_micro):
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
