"""Continuous-batching serving engine with energy-attributed telemetry.

``ContinuousEngine`` runs true continuous batching over one telemetry
pipeline (a ``repro_torch.telemetry`` ``MonitorSession`` over the paper's
Sec. 4.1 probe/board/tag-bus platform), with power traces *derived* from the
roofline/DVFS energy model (``core.energy.ServePowerModel``): an
admission-controlled request queue, per-slot state behind a ``serve.state``
``CacheAdapter`` (the paged KV pool with radix prefix sharing), one fused
decode step with per-slot positions and one host sync per step, slot
recycling so new requests join mid-decode, per-request J/token attribution
via GPIO slot tags, and an energy-aware admission policy (DVFS power
capping + TTL shedding from measured throughput).

CUDA runs asynchronously, so every ``EngineTelemetry.record`` window ends
at a host sync — the first-token fetch of a prefill or the ``[B, 1]`` token
fetch of a decode step — and the device time of the window lands in it.
The reference's static ``ServeEngine`` baseline is not ported yet.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.energy import ServePowerModel
from repro_torch.core.hw import DeviceSpec, H100_SXM
from repro_torch.core.scheduler import ThroughputStats
from repro_torch.core.tags import N_GPIO
from repro_torch.obs import NULL_SPAN, MetricsRegistry, TelemetryEvent, Tracer
from repro_torch.serve.queue import AdmissionController, Request, RequestQueue
from repro_torch.serve.slots import SlotManager
from repro_torch.serve.state import make_adapter, resolve_buckets, to_device
from repro_torch.serve.step import TraceStats, bucket_for
from repro_torch.telemetry import ModelSource, MonitorSession

__all__ = ["Request", "ContinuousEngine", "EngineTelemetry",
           "resolve_buckets"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _count_params(params) -> float:
    return float(sum(int(np.prod(l.shape)) for l in _leaves(params)))


def _cache_bytes(model, batch_size, max_seq) -> float:
    """KV-cache footprint (bytes) from its shape, without allocating it:
    a k and a v stack of ``model.cache_shape`` in ``init_cache``'s default
    dtype (bf16)."""
    n = int(np.prod(model.cache_shape(batch_size, max_seq)))
    return float(2 * n * torch.bfloat16.itemsize)


class EngineTelemetry:
    """Engine-side policy over a ``repro_torch.telemetry`` ``MonitorSession``.

    Phase tags ("prefill"/"decode") use two GPIO channels; the remaining
    channels carry per-slot tags so board energy can be attributed to the
    request owning each slot. With more slots than spare channels, slots
    share tags round-robin and a shared tag's energy splits equally among
    its active slots (board power is one stream; concurrent attribution
    needs a split policy — we use equal shares).
    """

    N_PHASE_TAGS = 2

    def __init__(self, power_model: ServePowerModel, batch_size: int,
                 node: str = "serve-node",
                 metrics: Optional[MetricsRegistry] = None):
        self.pm = power_model
        self.source = ModelSource(power_model)
        self.session = MonitorSession(self.source, node=node)
        self.n_slot_tags = max(1, min(batch_size, N_GPIO - self.N_PHASE_TAGS))
        self.metrics = metrics
        # per-window event log: what a replay needs to re-drive this session
        # deterministically against a recorded trace, and what a timeline
        # exporter merges with the span stream (typed schema)
        self.events: List[TelemetryEvent] = []

    def slot_tag(self, slot_index: int) -> str:
        return f"s{slot_index % self.n_slot_tags}"

    def record(self, phase: str, wall_s: float, n_tokens: int,
               slot_to_req: Dict[int, Request],
               extra: Optional[Dict] = None) -> Optional[TelemetryEvent]:
        """Sample ``wall_s`` of board power under ``phase`` + slot tags and
        attribute each sample's energy to the requests owning the slots
        (vectorized bitmask share computation on the columnar block).

        ``session.sample`` keeps windows on the global 1-kHz grid, so
        sub-millisecond steps carry their fraction into the next window
        instead of silently dropping energy. ``n_tokens`` is the *computed*
        token count — a prefix-cache-served span burns no board time, so the
        engine passes only the recomputed tail and shared-prefix joules are
        attributed once, to the request that actually computed them.
        ``extra`` (e.g. ``{"cached_tokens": ...}``) rides in the typed
        event for replay/analysis. Returns the :class:`TelemetryEvent`
        (its ``window`` index is what step spans reference for energy
        attribution), or None for a non-positive window."""
        if wall_s <= 0:
            return None
        self.source.set_step(n_tokens, wall_s, t0=self.session.cursor)
        tag_groups: Dict[str, List[Request]] = {}
        for idx, req in slot_to_req.items():
            tag_groups.setdefault(self.slot_tag(idx), []).append(req)
        event = TelemetryEvent(
            phase=phase, wall_s=wall_s, n_tokens=n_tokens,
            groups={tg: tuple(r.req_id for r in reqs)
                    for tg, reqs in tag_groups.items()},
            window=self.session.n_windows, t0=self.session.cursor,
            extra=dict(extra or {}))
        self.events.append(event)
        try:
            block = self.session.sample(wall_s,
                                        tags=[phase] + sorted(tag_groups))
        finally:
            self.source.clear()
        per_tag = block.split_energy(
            {tg: len(reqs) for tg, reqs in tag_groups.items()})
        for tg, reqs in tag_groups.items():
            share = per_tag.get(tg, 0.0) / len(reqs)
            if share:
                for r in reqs:
                    r.energy_j += share
        if self.metrics is not None:
            self.metrics.counter(
                "engine_energy_j", "board joules by phase").inc(
                block.energy_j(), phase=phase)
        return event

    def energy_stats(self) -> Dict:
        rep = self.session.report()
        out = {"energy_j": rep.energy_j, "energy_by_tag": dict(rep.by_tag)}
        if rep.counters:
            out["counters"] = dict(rep.counters)
        return out


# ---------------------------------------------------------------------------
# continuous batching


class ContinuousEngine:
    """Continuous batching over one shared per-slot state store.

    Requests queue up (``submit``) and ``run`` drains them: free slots are
    filled via single-slot prefills (other slots keep their in-flight
    state), every decode step advances *all* active slots with one fused
    step (per-slot positions, greedy sampling on the device, one [B,1] host
    fetch), and a slot is recycled the moment its request hits EOS or its
    token budget — so late requests join mid-decode instead of waiting for
    the batch to drain.

    All per-slot state handling (the paged KV pool here; window rings and
    recurrent carried state in later slices) lives behind ``self.adapter``
    (``serve.state.CacheAdapter``), selected by the model family's declared
    ``ServingCaps`` — the engine body is family-agnostic.
    """

    def __init__(self, model, params, *, batch_size: int, max_seq: int,
                 telemetry: bool = True, dev: DeviceSpec = H100_SXM,
                 power_cap_w: Optional[float] = None,
                 prefill_buckets="auto", kv_block_size="auto",
                 prefix_cache: bool = True,
                 kv_pool_blocks: Optional[int] = None,
                 tracing: bool = True):
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.trace_stats = TraceStats()
        # the family-declared backend: paged KV (flat transformers), window
        # rings (gemma3) / contiguous fallback, or recurrent carried state.
        # "auto" arguments degrade where the family can't honor them;
        # explicit requests on an incapable family raise early.
        self.adapter = make_adapter(
            model, params, batch_size=batch_size, max_seq=max_seq,
            prefill_buckets=prefill_buckets, kv_block_size=kv_block_size,
            prefix_cache=prefix_cache, kv_pool_blocks=kv_pool_blocks,
            trace_stats=self.trace_stats,
            on_compile=self._on_compile)
        self.family = model.cfg.family
        self.pm = ServePowerModel(
            _count_params(params), dev=dev,
            cache_bytes=_cache_bytes(model, batch_size, max_seq))
        self.stats = ThroughputStats()
        self.admission = AdmissionController(self.pm, power_cap_w, self.stats)
        self.queue = RequestQueue()
        self.slots = SlotManager(batch_size, max_seq)
        # observability: registry-backed run stats + request-lifecycle spans
        # (queued -> admitted -> prefill -> decode -> finish) and per-step
        # engine spans carrying window refs for an energy-attributed
        # timeline export
        self.metrics = MetricsRegistry()
        self.tracer = Tracer() if tracing else None
        self._req_spans: Dict[int, object] = {}   # req_id -> open span
        self.tel = (EngineTelemetry(self.pm, batch_size,
                                    metrics=self.metrics)
                    if telemetry else None)
        # every telemetry event / engine-step span carries the backend and
        # family so Perfetto timelines and .dkt replay can tell paged,
        # ring, and recurrent slots apart
        self._slot_attrs = {"adapter": self.adapter.kind,
                            "family": self.family}
        self.dvfs = self.admission.apply_dvfs(batch_size)
        self.finished: List[Request] = []

    # attribute aliases: the adapter owns the state, but benches/tests/
    # launchers address it through the engine
    @property
    def buckets(self):
        return self.adapter.buckets

    @property
    def block_size(self):
        return self.adapter.block_size

    @property
    def pages(self):
        return self.adapter.pages

    @property
    def prefix(self):
        return self.adapter.prefix

    @property
    def caches(self):
        return self.adapter.caches

    def _on_compile(self, name: str):
        if self.tel is not None:
            self.tel.session.count(f"compiles/{name}")
        self.metrics.counter("jit_compiles",
                             "new step signatures").inc(step=name)

    # -- request intake ------------------------------------------------------

    def submit(self, req: Request):
        """Queue a request. The prompt must leave at least one decode
        position; a generation budget that would overrun the cache is
        accepted — the request finishes early with reason "capacity" when
        it hits the last position (the old behavior silently clamped the
        position and overwrote the final KV entry every step)."""
        if len(req.prompt) + 1 > self.max_seq:
            raise ValueError(
                f"request {req.req_id}: prompt of {len(req.prompt)} leaves "
                f"no decode position with max_seq={self.max_seq}")
        if self.adapter.caps.needs_frames and req.frames is None:
            raise ValueError(
                f"request {req.req_id}: family '{self.family}' is "
                "encoder-decoder — attach encoder frames "
                "(Request(frames=[enc_seq, d_model])) so the first prefill "
                "chunk can build the cross-attention cache")
        self.queue.push(req)
        self.metrics.counter("requests_submitted").inc()
        if self.tracer is not None:
            # lifecycle span 1: time on the queue. Ended (and chained into
            # prefill/decode spans) at admission, or closed with the shed
            # reason — _close_req_span owns the hand-off.
            self._req_spans[req.req_id] = self.tracer.begin(
                "queued", track=f"req{req.req_id}", req_id=req.req_id,
                prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens)

    def _close_req_span(self, req: Request, **attrs):
        """End the request's open lifecycle span (queued or decode)."""
        sp = self._req_spans.pop(req.req_id, None)
        if sp is not None:
            sp.update(**attrs)
            sp.end()

    # -- slot lifecycle ------------------------------------------------------

    def _finish(self, slot, reason: str):
        req = slot.req
        req.done = True
        req.finish_reason = reason
        self.finished.append(req)
        self.metrics.counter("requests_finished",
                             "requests by finish reason").inc(reason=reason)
        self._close_req_span(req, finish_reason=reason,
                             tokens=len(req.output), energy_j=req.energy_j)
        if self.tracer is not None:
            self.tracer.instant("finish", track=f"req{req.req_id}",
                                req_id=req.req_id, finish_reason=reason)
        # release/reset the slot's backend state (page refs dropped and
        # scrub-queued, or the row reset) so the next occupant starts clean
        self.adapter.free_slot(slot.index)
        self.slots.release(slot)

    def _emit(self, slot, tok: int):
        req = slot.req
        req.output.append(tok)
        self.metrics.counter("tokens_decoded").inc()
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(slot, "eos")
        elif req.n_generated >= req.max_new_tokens:
            self._finish(slot, "length")

    def _shed_stale(self):
        """TTL shedding: a queued request's predicted wait is the remaining
        decode budget ahead of it (active slots + queue positions in front)
        cleared at the measured decode rate, plus the queued prompts ahead
        cleared at the measured prefill rate. Prompts are priced net of the
        span the prefix cache is expected to serve — a warm shared prefix
        costs no prefill compute, and pricing it gross sheds requests that
        would easily meet their TTL."""
        if not self.queue:
            return
        ahead = sum(s.req.max_new_tokens - s.req.n_generated
                    for s in self.slots.active_slots())
        ahead_prefill = 0
        for req in self.queue.snapshot():
            if self.admission.should_shed(req, ahead, ahead_prefill):
                self.queue.shed(req)     # shed() drops it from the queue too
                self.metrics.counter("requests_shed",
                                     "sheds by reason").inc(reason="ttl")
                self._close_req_span(req, finish_reason=req.finish_reason)
            else:
                # a queued request costs its prompt (prefill) AND its
                # budget (decode) — tracked separately so each phase is
                # priced at its own measured rate
                ahead += req.max_new_tokens
                ahead_prefill += max(
                    0, len(req.prompt) - self.adapter.expected_cached(req))

    def _admit(self):
        """Fill free slots from the queue, subject to the admission policy
        (power cap, TTL) and — when paged — page availability: a request is
        admitted only if the pool can back its worst-case footprint, else
        admission defers until active requests free pages."""
        self._shed_stale()
        while self.queue and self.slots.free_slots():
            if self.admission.max_slots(self.batch_size) == 0:
                while self.queue:        # cap below even 1-slot power: shed
                    req = self.queue.pop()
                    self.queue.shed(req, "shed-cap")
                    self.metrics.counter("requests_shed",
                                         "sheds by reason").inc(reason="cap")
                    self._close_req_span(req, finish_reason="shed-cap")
                break
            if not self.admission.admit(self.slots.n_active, self.batch_size):
                break                     # defer under the power cap
            if not self.adapter.can_admit(self.queue.peek()):
                break                     # defer until backend capacity frees
            req = self.queue.pop()
            if req.max_new_tokens <= 0:
                req.done = True
                req.finish_reason = "length"
                self.finished.append(req)
                self.metrics.counter(
                    "requests_finished",
                    "requests by finish reason").inc(reason="length")
                self._close_req_span(req, finish_reason="length", tokens=0)
                continue
            self._prefill_into(self.slots.free_slots()[0], req)

    def _prefill_into(self, slot, req: Request):
        self._close_req_span(req)        # queued span ends at admission
        psp = NULL_SPAN
        if self.tracer is not None:
            self.tracer.instant("admitted", track=f"req{req.req_id}",
                                req_id=req.req_id, slot=slot.index)
            psp = self.tracer.begin("prefill", track=f"req{req.req_id}",
                                    req_id=req.req_id, slot=slot.index,
                                    **self._slot_attrs)
        t0 = time.perf_counter()
        out = self.adapter.prefill(slot.index, req)
        if out.first_token is None:
            # backend dry (undersized page pool): the adapter already
            # dropped the slot's resources; finish the request here
            req.done = True
            req.finish_reason = "pages"
            self.finished.append(req)
            self.metrics.counter("requests_finished",
                                 "requests by finish reason").inc(
                reason="pages")
            psp.update(finish_reason="pages")
            psp.end()
            return
        first, cached, tail_len = (out.first_token, out.cached_tokens,
                                   out.computed_tokens)
        dt = time.perf_counter() - t0
        req.prefill_s = dt
        req.cached_prompt_tokens = cached
        self.metrics.histogram("prefill_step_s",
                               "per-prefill wall seconds").observe(dt)
        self.metrics.counter(
            "prefill_tokens_computed",
            "prompt tokens actually run (cache hits and bucket pad "
            "excluded)").inc(tail_len)
        # throughput + energy see only the *computed* tail: cached tokens
        # burn no board time, so shared-prefix joules are attributed once —
        # to the request that actually ran the prefill
        self.stats.observe("prefill", tail_len, dt)
        ev = None
        if self.tel:
            extra = dict(self._slot_attrs)
            if cached:
                extra["cached_tokens"] = cached
            ev = self.tel.record("prefill", dt, tail_len, {slot.index: req},
                                 extra=extra)
        psp.update(bucket=(bucket_for(tail_len, self.buckets)
                           if self.buckets else tail_len),
                   cached_tokens=cached, computed_tokens=tail_len,
                   window=ev.window if ev is not None else -1)
        psp.end()
        self.slots.assign(slot, req, first)
        if self.tracer is not None:
            # lifecycle span 3: decode residency — closed by _finish with
            # the finish reason and attributed joules
            self._req_spans[req.req_id] = self.tracer.begin(
                "decode", track=f"req{req.req_id}", req_id=req.req_id,
                slot=slot.index)
        self._emit(slot, first)   # prefill samples the first token

    def _decode_once(self):
        # pre-step backend bookkeeping (paged: back every active write
        # position, COW defensively-shared blocks); slots the backend can
        # no longer cover finish "pages"
        for s in self.adapter.begin_step(list(self.slots.active_slots())):
            self._finish(s, "pages")
        active = self.slots.active_slots()
        if not active:
            return
        # per-step engine span: queue depth + pool occupancy gauges ride on
        # it, and the step's sample window is referenced for the timeline's
        # exact joule partition
        depth = len(self.queue)
        free, evictable = self.adapter.pool_gauges()
        self.metrics.gauge("queue_depth").set(depth)
        if self.pages is not None:
            self.metrics.gauge("kv_free_blocks").set(free)
        if self.prefix is not None:
            self.metrics.gauge("kv_evictable_blocks").set(evictable)
        step_cm = (self.tracer.span(
            "decode_step", track="engine", active=len(active),
            queue_depth=depth, free_blocks=free, evictable_blocks=evictable,
            **self._slot_attrs)
            if self.tracer is not None else contextlib.nullcontext(NULL_SPAN))
        with step_cm as ssp:
            dev = self.adapter.device
            tokens = to_device(self.slots.batch_tokens(), dev)
            pos = to_device(self.slots.batch_positions(), dev)
            t0 = time.perf_counter()
            next_tok = self.adapter.decode_step(tokens, pos)
            # dalek: allow[host-sync] the designed once-per-step [B,1] fetch (EOS/budget checks)
            toks = next_tok.cpu().numpy()
            dt = time.perf_counter() - t0
            self.metrics.histogram("decode_step_s",
                                   "fused decode step wall seconds").observe(dt)
            self.stats.observe("decode", len(active), dt)
            if self.tel:
                ev = self.tel.record("decode", dt, len(active),
                                     {s.index: s.req for s in active},
                                     extra=dict(self._slot_attrs))
                if ev is not None:
                    ssp.set("window", ev.window)
        for s in active:
            s.req.decode_steps += 1
            tok = int(toks[s.index, 0])
            self.slots.advance(s, tok)
            self._emit(s, tok)
            # the clamp fix: a request that filled the cache finishes here
            # instead of silently overwriting the last KV position forever
            if s.req is not None and self.slots.at_capacity(s):
                self._finish(s, "capacity")

    # -- driver --------------------------------------------------------------

    def run(self) -> Dict:
        """Drain the queue; returns aggregate + per-request stats."""
        self.adapter.ensure_ready()       # lazy state allocation
        while True:
            self._admit()
            if self.slots.n_active == 0:
                break
            self._decode_once()
        # run stats are read back out of the metrics registry — the same
        # store --metrics-json snapshots and prometheus() exposes
        n_emitted = int(self.metrics.counter("tokens_decoded").total())
        dec = self.metrics.histogram("decode_step_s")
        pre = self.metrics.histogram("prefill_step_s")
        stats = {
            "completed": len(self.finished),
            "shed": self.queue.n_shed,
            "tokens_decoded": n_emitted,
            "prefill_s": pre.sum(),
            "decode_s": dec.sum(),
            "decode_steps": dec.count(),
            "decode_tok_per_s": (n_emitted / dec.sum()
                                 if dec.sum() else 0.0),
            "prefills": self.slots.n_assigned,
            "prompt_tokens": self.slots.n_prefill_tokens,
            "prefill_tokens_computed": int(self.metrics.counter(
                "prefill_tokens_computed").total()),
            "slots_recycled": self.slots.n_released,
            "peak_active": self.slots.peak_active,
            "dvfs_f_ghz": self.dvfs.f_ghz if self.dvfs else None,
            "prefill_compiles": self.trace_stats.compiles("prefill"),
            "decode_compiles": self.trace_stats.compiles("decode"),
            # every executable family the engine traced — incl. the state
            # maintenance ops (reset_slot / state_scatter / zero_blocks /
            # copy_block)
            "compiles": self.trace_stats.snapshot(),
            "prefill_buckets": list(self.buckets) if self.buckets else None,
            "adapter": self.adapter.kind,
            "family": self.family,
        }
        stats.update(self.adapter.run_stats())   # kv_block_size, kv_pages, …
        if self.tel:
            stats.update(self.tel.energy_stats())
        return stats

    def serve(self, reqs: List[Request]) -> Dict:
        """Convenience: submit all and drain."""
        for r in reqs:
            self.submit(r)
        return self.run()

    def reset_metrics(self):
        """Clear counters, queue state, and samples (benchmark warmup);
        the KV pool survives — freed slots are always
        re-prefilled before reuse, so stale KV is never read.
        ``trace_stats`` is intentionally NOT cleared: compile counts track
        the engine's lifetime executable set (the thing the bucket bound
        promises), while the telemetry session's ``compiles/*`` counters
        reset with the samples they annotate."""
        self.finished = []
        self.metrics.clear()
        if self.tracer is not None:
            self.tracer.clear()
        self._req_spans = {}
        self.queue = RequestQueue()
        self.slots = SlotManager(self.batch_size, self.max_seq)
        # backend statistics reset (prefix trie cleared, pool stats zeroed):
        # a benchmark's measured phase must not reap hits the warmup planted
        # (the warmup's *compiles* are exactly what reset keeps — same
        # policy as trace_stats below)
        self.adapter.reset_metrics()
        if self.tel:
            self.tel.session.reset()
            self.tel.events = []       # event log tracks the sample stream
