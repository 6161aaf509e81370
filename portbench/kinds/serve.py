"""Serve cells: a closed loop of clients over the port's continuous
engine (``repro_torch.serve.engine.ContinuousEngine`` on its paged KV
adapter, with the launcher's defaults), a measured window, and the check
of what the window served against the plain reference.

The harness owns the clock. It calls the two steps of the engine's
``run()`` loop itself (``_admit``, then ``_decode_once``) and, the moment a
client's reply is complete, submits that client's next request. A
request's send time is when its client sent it; its first-token time is
when the engine call that prefilled it returned (the harness times each
prefill, ``_prefill_into``, and each decode step). Tokens are delivered
when the call that made them returns.

Set-up (``setup_s``) runs from process start to the window's opening: the
imports, the weights, one prefill at every bucket the mix can use, and a
lead-in of the same traffic: the clients ramp up, ``RAMP_PER_STEP``
before each engine step, and the window opens after the mix's
``lead_in_steps`` steps. The window closes at the end
of the first engine call at or past ``seconds``; a request counts if it was
sent in the window, a token if it was delivered in it. Then clients stop
sending, and the loop runs until every request the window sent has its
answer (at most ``DRAIN_S`` more).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench import generator, nvml, roofline, trace
from portbench.reference import decoder, judge

DRAIN_S = 60.0
#: clients the lead-in starts before each engine step
RAMP_PER_STEP = 2
#: profiler sessions a traced window holds, and the longest of them
TRACE_SESSIONS, TRACE_SESSION_S = 8, 1.5


def model_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=cfg["name"], **cfg["model"])


def build(cfg: Dict, seed: int, device):
    """(the port's model, the weights drawn from ``seed``): the tree of
    the reference's ``param_shapes``, held to the program's own."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.transformer import param_shapes
    from portbench.weights import draw, spec_shapes
    mcfg = model_config(cfg)
    spec = decoder.param_shapes(cfg["model"])
    if spec_shapes(spec) != spec_shapes(param_shapes(mcfg)):
        raise RuntimeError("the program's parameter tree differs from the "
                           "reference's")
    weights = draw(spec, seed, device, getattr(torch, cfg["model"]["dtype"]))
    return build_model(mcfg), weights


def warm_lengths(mix: Dict, max_seq: int) -> List[int]:
    """Prompt lengths that reach every power-of-two bucket the mix's
    prompts, and the uncached tails of its prefix hits, can fall in. A
    hit's tail is the fresh part and the document's last partial block
    (up to 31 tokens in the engine's 32-token blocks)."""
    ranges = [generator.prompt_range(mix)]
    if mix.get("corpus"):
        lo, hi = generator.fresh_range(mix)
        ranges.append((lo, hi + 31))
    out = set()
    for lo, hi in ranges:
        out |= {lo, hi}
        p = 8
        while p < hi:
            if p >= lo:
                out.add(p + 1)
            p *= 2
    return sorted(min(n, max_seq - 2) for n in out)


class Sent:
    __slots__ = ("req", "client", "send_t", "first_t", "done_t", "phase")

    def __init__(self, req, client, send_t, phase):
        self.req, self.client, self.send_t, self.phase = (req, client,
                                                          send_t, phase)
        self.first_t = self.done_t = None


class Loop:
    """Clients, each working through sessions of turns, over one engine."""

    def __init__(self, engine, sessions, clients: int, spans: List):
        self.engine = engine
        self.sessions = iter(sessions)
        self.cur = {}                      # client -> (session, next turn)
        self.by_id: Dict[int, Sent] = {}
        self.inflight: Dict[int, Sent] = {}
        self.done_tokens = 0
        self.n_seen = 0
        self.next_id = 0
        self.sending = True
        prefill_into, decode_once = engine._prefill_into, engine._decode_once

        def timed_prefill(slot, req):
            a = time.perf_counter_ns()
            prefill_into(slot, req)
            b = time.perf_counter_ns()
            spans.append(("prefill", a, b))
            if req.output:
                self.by_id[req.req_id].first_t = b / 1e9

        def timed_decode():
            a = time.perf_counter_ns()
            decode_once()
            spans.append(("decode_step", a, time.perf_counter_ns()))

        engine._prefill_into = timed_prefill
        engine._decode_once = timed_decode
        self.clients = clients

    def send(self, client: int, t: float, phase: str):
        from repro_torch.serve.queue import Request
        sess, i = self.cur.get(client, (None, 0))
        if sess is None or i >= len(sess.turns):
            sess, i = next(self.sessions, None), 0
            if sess is None:
                raise RuntimeError("the mix ran out of sessions: raise its "
                                   "\"sessions\"")
        turn = sess.turns[i]
        self.cur[client] = (sess, i + 1)
        req = Request(self.next_id, turn.prompt, turn.max_new_tokens,
                      eos_id=None)
        self.next_id += 1
        s = Sent(req, client, t, phase)
        self.by_id[req.req_id] = self.inflight[req.req_id] = s
        self.engine.submit(req)

    def step(self) -> float:
        """One turn of the engine's loop; returns the host time it ended."""
        self.engine._admit()
        if self.engine.slots.n_active:
            self.engine._decode_once()
        return time.perf_counter()

    def collect(self, now: float, phase: str):
        """Note the requests the last step finished; their clients send
        their next requests at ``now`` unless sending has stopped."""
        fin = self.engine.finished
        for req in fin[self.n_seen:]:
            s = self.inflight.pop(req.req_id)
            s.done_t = now
            self.done_tokens += len(req.output)
            if self.sending:
                self.send(s.client, now, phase)
        self.n_seen = len(fin)

    def delivered(self) -> int:
        return self.done_tokens + sum(len(s.req.output)
                                      for s in self.inflight.values())


def registry(engine) -> Dict:
    m = engine.metrics
    pre, dec = m.histogram("prefill_step_s"), m.histogram("decode_step_s")
    return {"prefill_s": pre.sum(),
            "prefill_tokens": m.counter("prefill_tokens_computed").total(),
            "decode_s": dec.sum(), "decode_steps": dec.count()}


class FlashLog:
    """Shapes of each flash launch, kept while a profiler session runs."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops
        self.ops, self.orig, self.on = ops, ops._launch, False
        self.launches: List = []

        def launch(q, k, v, causal, window, q_offset, route, block_m):
            if self.on:
                b, h, s, d = q.shape
                self.launches.append((time.perf_counter_ns(), b, h,
                                      k.shape[1], s, k.shape[2], d,
                                      int(q_offset), bool(causal), window))
            return self.orig(q, k, v, causal, window, q_offset, route,
                             block_m)

        ops._launch = launch

    def close(self):
        self.ops._launch = self.orig


def flash_share(sessions: List[Dict], logs: List) -> Optional[Dict]:
    """(least seconds, kernel seconds) of the flash launches of the whole
    sessions whose every launch the profile kept."""
    least = kern = 0.0
    n = 0
    for sess, launches in zip(sessions, logs):
        if sess is None:
            continue
        ks = [(a, b) for a, b, name in sess["kernels"] if "flash_fwd" in name]
        if len(ks) != len(launches):
            continue
        kern += sum(b - a for a, b in ks) / 1e9
        for _, b, h, hkv, s, t, d, off, causal, window in launches:
            least += roofline.least_seconds(*roofline.flash_cost(
                b, h, hkv, s, t, d, off, causal, window))
        n += len(launches)
    if n == 0:
        return None
    return {"least_s": least, "kernel_s": kern, "launches": n}


class Tracer:
    """The profiler sessions of a traced window: ``TRACE_SESSIONS`` of
    them, centred in equal parts of the window, each opened and closed
    between engine calls."""

    def __init__(self, t_open: float, seconds: float, flash: FlashLog):
        self.length = min(TRACE_SESSION_S, seconds / (2 * TRACE_SESSIONS))
        self.starts = [t_open + (i + 0.5) * seconds / TRACE_SESSIONS
                       - self.length / 2 for i in range(TRACE_SESSIONS)]
        self.flash, self.active, self.t = flash, None, 0.0
        self.sessions, self.logs = [], []

    def tick(self, now: float):
        if self.active is None and self.starts and now >= self.starts[0]:
            self.starts.pop(0)
            self.active, self.t = trace.Session(), now
            self.flash.launches, self.flash.on = [], True
            self.active.start()
        elif self.active is not None and now - self.t >= self.length:
            self.flash.on = False
            self.active.stop()
            self.sessions.append(self.active)
            self.logs.append(self.flash.launches)
            self.active = None


def measure(loop: Loop, lead_in_steps: int, seconds: float, at_open,
            at_close, tracer=None) -> Dict:
    """Lead-in, window and drain over ``loop``.

    The lead-in ramps the clients up, ``RAMP_PER_STEP`` more before each
    engine step, and ends with its ``lead_in_steps``-th step. The engine's
    schedule (which request is prefilled and decoded in which step)
    depends on the sizes and not on the clock, so every run's window opens
    at the same point of it, on the same requests. Clients the lead-in did
    not reach
    start as the window opens. ``at_open``/``at_close`` read the counters
    at the window's edges; ``tracer(t_open)`` makes a ``Tracer``. Returns
    the edges' times and readings, the tokens delivered in the window and
    the requests sent in it."""
    t_lead = time.perf_counter()
    now, started = t_lead, 0
    for _ in range(lead_in_steps):
        for c in range(started, min(loop.clients, started + RAMP_PER_STEP)):
            loop.send(c, now, "lead")
        started = min(loop.clients, started + RAMP_PER_STEP)
        now = loop.step()
        loop.collect(now, "lead")
    t_open = now
    for c in range(started, loop.clients):
        loop.send(c, now, "window")
    opened, tok0 = at_open(), loop.delivered()
    tr = tracer(t_open) if tracer is not None else None
    while True:
        if tr is not None:
            tr.tick(now)
        now = loop.step()
        if now - t_open >= seconds and (tr is None or tr.active is None):
            break
        loop.collect(now, "window")
    t_close = now
    closed, tok1 = at_close(), loop.delivered()
    loop.sending = False
    loop.collect(now, "window")
    while loop.inflight and time.perf_counter() - t_close < DRAIN_S:
        loop.collect(loop.step(), "window")
    return {"t_lead": t_lead, "t_open": t_open, "t_close": t_close,
            "opened": opened, "closed": closed, "tokens": tok1 - tok0,
            "window": [s for s in loop.by_id.values()
                       if s.phase == "window"],
            "sessions": tr.sessions if tr is not None else [],
            "logs": tr.logs if tr is not None else []}


def phases(spans, t_open: float, t_close: float) -> Dict:
    """{span name: [count, seconds]} of the harness's spans inside the
    window, and the window's seconds outside every span ("other")."""
    out: Dict = {}
    lo, hi = t_open * 1e9, t_close * 1e9
    for name, a, b in spans:
        if a >= lo and b <= hi:
            n, t = out.get(name, (0, 0.0))
            out[name] = [n + 1, t + (b - a) / 1e9]
    out["other"] = [0, t_close - t_open - sum(t for _, t in out.values())]
    return out


def check_sample(window: List[Sent], seed: int, tokens: int) -> List[Sent]:
    """The requests the check reads: the longest one the window sent and
    finished, then others drawn from the seed until they served
    ``tokens``."""
    done = [s for s in window if s.req.finish_reason == "length"]
    if not done:
        return []
    rng = np.random.default_rng([seed, 3])
    first = max(done, key=lambda s: len(s.req.prompt) + len(s.req.output))
    out, n = [first], len(first.req.output)
    for i in rng.permutation(len(done)):
        if n >= tokens:
            break
        if done[i] is not first:
            out.append(done[i])
            n += len(done[i].req.output)
    return out


def verdict(cmp: Dict, check: Dict, unfinished: int,
            prefix: str = "") -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}) of the comparison ``cmp``:
    each of the configuration's limits, no request the window sent left
    unanswered, and at least ``served_tokens`` tokens read. ``prefix``
    "control_" judges the control's readings, in the program's place."""
    checks = {name: {"value": cmp.get(prefix + name), "limit": limit}
              for name, limit in check["limits"].items()}
    checks["unfinished"] = {"value": unfinished, "limit": 0}
    checks["checked_tokens"] = {"value": cmp["tokens"],
                                "limit": check["served_tokens"]}
    correct = (all(c["limit"] is not None and c["value"] is not None
                   and c["value"] <= c["limit"]
                   for n, c in checks.items() if n != "checked_tokens")
               and cmp["tokens"] >= check["served_tokens"])
    return bool(correct), checks


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, *, trace_on: bool,
        device: str, t0: float, energy=None) -> Dict:
    """One run of a serve cell. ``energy``: an ``nvml.Nvml`` (None: no
    energy reading). Returns the record the metrics read, with
    ``correct``, ``checks`` and the device's peak memory; with the
    configuration's ``check["control"]`` on, also the fp8 control's
    ``correct`` and ``checks`` by the same ``verdict`` (``control``)."""
    import torch
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.queue import Request
    eng_cfg, check = cfg["engine"], cfg["check"]
    max_seq = eng_cfg["max_seq"]
    _, longest = generator.longest(mix)
    if longest > max_seq:
        raise ValueError(f"the mix's longest request ({longest} positions) "
                         f"does not fit max_seq {max_seq}")
    cuda = device == "cuda"
    t_start = time.perf_counter()
    model, weights = build(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    t_built = time.perf_counter()
    sessions = generator.sessions(mix, seed, cfg["model"]["vocab_size"])
    engine = ContinuousEngine(model, weights, batch_size=eng_cfg["batch"],
                              max_seq=max_seq,
                              kv_pool_blocks=eng_cfg.get("kv_pool_blocks"))
    rng = np.random.default_rng([seed, 4])
    warm = [Request(-1 - i, rng.integers(1, cfg["model"]["vocab_size"], n,
                                         dtype=np.int32), 2)
            for i, n in enumerate(warm_lengths(mix, max_seq))]
    spans: List = []
    flash = FlashLog() if trace_on else None
    with torch.no_grad():
        engine.serve(warm)
        engine.reset_metrics()
        engine.adapter.ensure_ready()
        t_warm = time.perf_counter()
        loop = Loop(engine, sessions, mix["clients"], spans)

        def at_open():
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            return (registry(engine),
                    energy.energy_mj() if energy is not None else None)

        def at_close():
            return (registry(engine),
                    energy.energy_mj() if energy is not None else None)

        tracer = ((lambda t_open: Tracer(t_open, seconds, flash))
                  if trace_on else None)
        w = measure(loop, mix["lead_in_steps"], seconds, at_open, at_close,
                    tracer)
    if flash is not None:
        flash.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_lead, t_open, t_close = w["t_lead"], w["t_open"], w["t_close"]
    (reg0, mj0), (reg1, mj1) = w["opened"], w["closed"]
    window = w["window"]
    sessions_raw, logs = w["sessions"], w["logs"]
    unfinished = sum(1 for s in window if s.done_t is None)
    sample = [(s.req.prompt, list(s.req.output))
              for s in check_sample(window, seed, check["served_tokens"])]
    requests = [{"prompt": len(s.req.prompt),
                 "cached": s.req.cached_prompt_tokens,
                 "out": len(s.req.output), "reason": s.req.finish_reason,
                 "ttft_s": (None if s.first_t is None
                            else s.first_t - s.send_t)} for s in window]
    del engine, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cmp = (judge.compare(weights, cfg["model"], max_seq, sample,
                             control=check.get("control", False),
                             wrong_gap=check.get("wrong_gap"))
               if sample else {"tokens": 0})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    ref_s = time.perf_counter() - t_ref
    correct, checks = verdict(cmp, check, unfinished)
    traced = [trace.reduce_session(s.events(), s.host_tail_ns,
                                   s.host_start_ns) for s in sessions_raw]
    whole = [s for s in traced if s is not None]
    n_total = roofline.count_params(weights)
    rec = {
        "setup_s": t_open - t0, "window_s": t_close - t_open,
        "setup_parts": {"start": t_start - t0, "weights": t_built - t_start,
                        "engine_and_warm_up": t_warm - t_built,
                        "lead_in": t_open - t_lead},
        "tokens": w["tokens"],
        "requests": requests,
        "engine": {k: reg1[k] - reg0[k] for k in reg0},
        "energy_j": None if mj0 is None else nvml.joules(mj0, mj1),
        "active_params": roofline.active_params(cfg["model"], n_total),
        "sessions": whole, "sessions_tried": len(traced),
        "flash": flash_share(traced, logs) if trace_on else None,
        "spans": spans,
        "phases": phases(spans, t_open, t_close),
        "memory_peak_bytes": peak,
        "correct": correct, "checks": checks, "compare": cmp,
        "control": (dict(zip(("correct", "checks"),
                             verdict(cmp, check, unfinished, "control_")))
                    if check.get("control") and sample else None),
        "reference_s": ref_s,
        "attempted": len(window),
        "failed": sum(1 for s in window
                      if s.done_t is not None and s.req.finish_reason
                      != "length"),
    }
    return rec
