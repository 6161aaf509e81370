"""Training loop with the paper's energy platform as a first-class citizen.

Integrates: data prefetch, the train step, atomic async checkpoints,
region-tagged energy telemetry (a ``repro_torch.telemetry`` ``MonitorSession``
over the probe/main-board pipeline), DVFS power capping, and fault-tolerant
restart (resume from the newest committed checkpoint + step-indexed data).

The step's launches are asynchronous, so the step's wall time ends at the
host's one fetch of its metrics (one stacked copy, one sync), taken inside
the ``train_step`` region before the clock is read: the joules of the
step's device work then land in its own window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import energy as energy_mod
from repro_torch.core.hw import H100_SXM
from repro_torch.data.pipeline import Prefetcher
from repro_torch.obs import NULL_SPAN, MetricsRegistry, Tracer
from repro_torch.telemetry import MonitorSession, MutableSource


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    power_cap_w: Optional[float] = None
    n_chips: int = 1


def make_session(dev=H100_SXM, node: str = "train-node"):
    """Training telemetry: a ``MonitorSession`` over a host-updated power
    source. Each step derives node power from the measured step time and
    the roofline terms (utilization model), sets it on the source, and
    samples the 1000 SPS pipeline — tag-level attribution works exactly as
    on DALEK."""
    source = MutableSource(dev.idle_w)
    return MonitorSession(source, node=node), source


def fetch_metrics(metrics) -> Dict[str, float]:
    """The step's metrics on the host as floats: every tensor among them
    in one stacked copy, so a step costs one host sync."""
    keys = [k for k, x in metrics.items() if isinstance(x, torch.Tensor)]
    out = {k: float(np.asarray(x)) for k, x in metrics.items()
           if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in keys]).tolist()
        out.update(zip(keys, vals))
    return out


def run(train_step, state, data, loop_cfg: LoopConfig, device=None,
        roofline_terms: Optional[Dict[str, float]] = None,
        on_step: Optional[Callable] = None,
        tracer: Optional[Tracer] = None,
        metrics_registry: Optional[MetricsRegistry] = None,
        layout=None):
    """Run training; returns (state, history, summary).

    ``device``: where the batches go (None keeps the host's numpy
    batches). ``tracer``/``metrics_registry`` plug the loop into the unified
    observability layer: one ``train_step`` span per step (referencing its
    energy sample window for the timeline export), ``checkpoint`` spans,
    and registry-backed counters the launcher can snapshot to JSON.
    ``layout``: the ``ShardedTrainStep`` of a state held in each rank's
    blocks; a checkpoint then gathers full leaves and rank 0 writes them,
    and a restore places each rank's blocks. Every rank feeds the global
    batch, so the token count is the global batch's."""
    session, power = make_session()
    m = metrics_registry if metrics_registry is not None else MetricsRegistry()
    dev = H100_SXM
    saver = ckpt_mod.AsyncSaver()
    writer = layout is None or torch.distributed.get_rank() == 0
    start_step = 0
    if loop_cfg.ckpt_dir:
        if writer:
            ckpt_mod.gc_partial(loop_cfg.ckpt_dir)
        if layout is not None:
            torch.distributed.barrier()
        steps = ckpt_mod.valid_steps(loop_cfg.ckpt_dir)
        if steps:
            state, manifest = ckpt_mod.restore(
                state, loop_cfg.ckpt_dir,
                shardings=None if layout is None else layout.shardings)
            start_step = manifest["step"]

    def save(step):
        full = state if layout is None else layout.gather(state)
        if writer:
            saver.save(full, loop_cfg.ckpt_dir, step)

    dvfs = None
    if loop_cfg.power_cap_w is not None and roofline_terms is not None:
        dvfs = energy_mod.cap_frequency(loop_cfg.power_cap_w, roofline_terms)

    prefetch = Prefetcher(data, start_step=start_step, device=device)
    history = []
    tokens_seen = 0
    try:
        for step in range(start_step, loop_cfg.total_steps):
            idx, batch = prefetch.next()
            assert idx == step, (idx, step)
            step_cm = (tracer.span("train_step", track="train", step=step + 1)
                       if tracer is not None
                       else contextlib.nullcontext(NULL_SPAN))
            t0 = time.perf_counter()
            with step_cm as sp, session.region("train_step"):
                state, metrics = train_step(state, batch)
                metrics = fetch_metrics(metrics)
                wall = time.perf_counter() - t0
                util = 1.0
                if roofline_terms:
                    t_pred = energy_mod.step_time_s(roofline_terms, dvfs)
                    util = min(roofline_terms["compute"] / max(t_pred, 1e-9), 1.0)
                # sample the probes across the step's wall time while the
                # GPIO tag is high (paper: tag-synchronized measurement)
                power.set(energy_mod.power_w(dev, util, dvfs))
                sp.set("window", session.n_windows)
                session.sample(wall)
            n_batch_tokens = int(np.prod(batch["tokens"].shape))
            tokens_seen += n_batch_tokens
            m.histogram("train_step_s",
                        "train step wall seconds").observe(wall)
            m.counter("train_tokens").inc(n_batch_tokens)
            m.gauge("train_energy_j",
                    "session joules so far (all chips)").set(
                session.energy_j() * loop_cfg.n_chips)
            rec = {"step": step + 1, "wall_s": wall,
                   "loss": float(metrics.get("loss", np.nan)),
                   "grad_norm": float(metrics.get("grad_norm", np.nan)),
                   "energy_j": session.energy_j() * loop_cfg.n_chips,
                   "tokens": tokens_seen}
            history.append(rec)
            if on_step:
                on_step(rec)
            if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
                ck_cm = (tracer.span("checkpoint", track="train",
                                     step=step + 1)
                         if tracer is not None
                         else contextlib.nullcontext(NULL_SPAN))
                with ck_cm, session.region("checkpoint"):
                    save(step + 1)
                if writer:
                    ckpt_mod.prune(loop_cfg.ckpt_dir, loop_cfg.ckpt_keep)
                m.counter("checkpoints_saved").inc()
        if loop_cfg.ckpt_dir:
            save(loop_cfg.total_steps)
            saver.wait()
    finally:
        prefetch.close()
    report = session.report(tokens=tokens_seen)
    summary = {
        "energy_j": report.energy_j * loop_cfg.n_chips,
        "energy_by_tag": dict(report.by_tag),
        # all-chip average power, consistent with the scaled energy_j
        "avg_power_w": report.avg_power_w * loop_cfg.n_chips,
        "tokens": tokens_seen,
        "j_per_token": (report.energy_j * loop_cfg.n_chips
                        / max(tokens_seen, 1)),
        "metrics": m.snapshot(),
        # the live session rides along (non-JSON) so callers can merge the
        # span stream with its energy windows in the timeline export
        "session": session,
    }
    return state, history, summary
