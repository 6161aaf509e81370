"""The window's arithmetic, on a stand-in engine and a stand-in clock: a
rate over the whole window, the 95th percentile over every request the
window sent, and the requests sent in the window that finish after it."""
import types

import numpy as np
import pytest

from portbench import spec
from portbench.kinds import serve
from portbench.generator import Session, Turn


class Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def perf_counter_ns(self):
        return int(round(self.t * 1e9))


class Engine:
    """Prefills one request a call of ``PREFILL`` s, decodes every slot one
    token a call of ``DECODE`` s."""
    PREFILL, DECODE = 0.5, 0.1

    def __init__(self, clock, batch):
        self.clock, self.batch = clock, batch
        self.queue, self.active, self.finished = [], [], []
        self.slots = types.SimpleNamespace(n_active=0)

    def submit(self, req):
        self.queue.append(req)

    def _prefill_into(self, slot, req):
        self.clock.t += self.PREFILL
        req.output.append(1)
        req.cached_prompt_tokens = 0
        self.active.append(req)

    def _admit(self):
        while self.queue and len(self.active) < self.batch:
            self._prefill_into(len(self.active), self.queue.pop(0))
        self.slots.n_active = len(self.active)

    def _decode_once(self):
        self.clock.t += self.DECODE
        for r in list(self.active):
            r.output.append(2)
            if len(r.output) >= r.max_new_tokens:
                r.finish_reason = "length"
                self.active.remove(r)
                self.finished.append(r)
        self.slots.n_active = len(self.active)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(serve, "time", c)
    return c


def _sessions(n, new):
    return [Session(None, [Turn(np.arange(1, 9, dtype=np.int32), new, 0)])
            for _ in range(n)]


def test_window_counts_its_tokens_its_sends_and_their_late_answers(clock):
    eng = Engine(clock, batch=2)
    loop = serve.Loop(eng, _sessions(200, 10), clients=2, spans=[])
    w = serve.measure(loop, 4, seconds=5.0,
                      at_open=lambda: loop.delivered(),
                      at_close=lambda: loop.delivered())
    # the window closes at the end of the first step at or past 5 s (a
    # step: the admissions' prefills, then one decode)
    step = 2 * Engine.PREFILL + Engine.DECODE
    assert 5.0 <= w["t_close"] - w["t_open"] < 5.0 + step + 1e-9
    assert w["tokens"] == w["closed"] - w["opened"]
    assert w["tokens"] > 0
    sent = w["window"]
    assert sent and all(w["t_open"] <= s.send_t < w["t_close"] for s in sent)
    late = [s for s in sent if s.done_t > w["t_close"]]
    assert late                                  # answered after the close
    assert all(s.done_t is not None and len(s.req.output) == 10
               for s in sent)                    # the drain finished them
    # the lead-in started both clients (two a step) and ended after its
    # 4 steps: two prefills, then a decode a step
    assert w["t_open"] - w["t_lead"] == pytest.approx(
        2 * Engine.PREFILL + 4 * Engine.DECODE)
    # no request the lead-in sent counts
    assert all(s.phase == "lead" for s in loop.by_id.values()
               if s.send_t < w["t_open"])


def test_rate_is_over_the_whole_window_and_p95_over_every_request():
    rec = {"tokens": 1234, "window_s": 45.5, "setup_s": 3.0,
           "requests": [{"ttft_s": t, "prompt": 10, "cached": 0}
                        for t in [0.1] * 95 + [2.0] * 5 + [None]],
           "engine": {"prefill_s": 2.0, "prefill_tokens": 4000,
                      "decode_s": 3.0, "decode_steps": 30},
           "energy_j": 4567.0, "active_params": 1e9}
    read = {m: spec.metric_reader(m)(rec) for m in
            ("tok_s", "ttft_p95_ms", "energy_j_per_tok", "setup_s",
             "prefill_ms_per_ktok", "decode_step_ms", "avg_power_w",
             "prefix_hit_share", "mfu")}
    assert read["tok_s"] == 1234 / 45.5
    assert read["ttft_p95_ms"] == pytest.approx(
        np.percentile([0.1] * 95 + [2.0] * 5, 95) * 1e3)
    assert read["energy_j_per_tok"] == 4567.0 / 1234
    assert read["prefill_ms_per_ktok"] == pytest.approx(500.0)
    assert read["decode_step_ms"] == pytest.approx(100.0)
    assert read["avg_power_w"] == 4567.0 / 45.5
    assert read["prefix_hit_share"] == 0.0
    assert read["mfu"] == pytest.approx(
        100 * 2e9 * (4000 + 1234) / (45.5 * 989e12))


def test_no_energy_reading_gives_no_energy_metric():
    rec = {"tokens": 10, "window_s": 1.0, "energy_j": None}
    assert spec.metric_reader("energy_j_per_tok")(rec) is None
    assert spec.metric_reader("avg_power_w")(rec) is None
