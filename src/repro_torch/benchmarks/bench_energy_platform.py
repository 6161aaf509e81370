"""Paper Sec. 4: energy measurement platform throughput + resolution.

Derived columns assert the platform's headline numbers: 1000 SPS per probe,
milliwatt resolution, 12-probe aggregation, tag attribution overhead — and
the comparison against GRID'5000 (~50 SPS @ 0.1 W).

Everything runs through the unified ``repro_torch.telemetry`` API.
Old-vs-columnar rows time the legacy per-``Sample``-object path
(``session.board``) against the columnar ``SampleBlock`` path on identical
streams (same probe seeds -> bit-equal watts), assert the energy totals
agree to 1e-9 J, and report the speedup. The record->reload rows time the
``repro_torch.tracestore`` ``.dkt`` round trip (write a session's stream,
mmap it back) and assert the reloaded columns are bit-exact.

A host bench, as in the reference: the probes, the main board and the trace
store are numpy on the host, so every row's derived column names the host
CPU (``common.host_cpu``), never the card. ``device`` is taken for the
runner's sake and not used.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_energy_platform
"""
import os
import tempfile

import numpy as np

from repro_torch.benchmarks.common import BenchRows, host_cpu, time_fn
from repro_torch.telemetry import (MILLIWATT, REPORT_SPS, MonitorSession,
                                   MutableSource, ProbeConfig,
                                   read_vectorized)
from repro_torch.tracestore import TraceReader, TraceWriter

READ_S = 0.5        # 12-probe read window (6000 samples/call)
TAG_S = 2.0         # single-probe tag-attribution window (2000 samples)


def _session(power_fn, n_probes=1):
    """Identically seeded sessions produce bit-equal streams, so the
    legacy and columnar paths can be compared head to head."""
    return MonitorSession([power_fn] * n_probes, node="bench")


def _bench_tracestore(record, host):
    """record -> reload: .dkt write+read round-trip overhead, bit-exact."""
    src = MutableSource(95.0)
    session = MonitorSession(src, node="trace-bench")
    with session.region("step"):
        for _ in range(10):
            session.sample(0.1)             # 10 windows, 1000 samples
    blocks = session.blocks()
    n = sum(b.n for b in blocks)
    with tempfile.TemporaryDirectory(prefix="dkt_bench_") as tmp:
        path = os.path.join(tmp, "bench.dkt")

        def write():
            with TraceWriter(path) as w:
                sid = w.add_stream("bench/probe0", node="bench",
                                   sps=REPORT_SPS)
                for b in blocks:
                    w.append(sid, b)
            return path

        t_w = time_fn(write, warmup=1, iters=5)
        nbytes = os.path.getsize(path)

        def read():
            with TraceReader(path) as r:
                return r.read(0).energy_j()

        t_r = time_fn(read, warmup=1, iters=5)
        with TraceReader(path) as r:
            back = r.read(0)
            live = session.block()
            assert np.array_equal(live.t, back.t)
            assert np.array_equal(live.watts, back.watts)
            assert np.array_equal(live.bits, back.bits)
            assert live.energy_j() == back.energy_j()
    record("energy/trace_record", t_w,
           f"{n / t_w:.0f}samples/s_written;{nbytes / t_w / 1e6:.0f}MB/s;"
           f"{nbytes / n:.1f}B/sample;host={host}")
    record("energy/trace_reload", t_r,
           f"{n / t_r:.0f}samples/s_read;roundtrip=bit_exact;host={host}")


def run(device=None):
    rows = BenchRows()
    record = rows.record
    host = host_cpu()
    power = lambda t: 80.0 + 10 * np.sin(t)   # noqa: E731 — array-capable

    # -- main-board read: legacy Sample objects vs columnar SampleBlock -----
    s_leg, s_col = _session(power, 12), _session(power, 12)
    t_leg = time_fn(lambda: s_leg.board.read_samples(READ_S),
                    warmup=1, iters=3)
    t_col = time_fn(lambda: s_col.board.read_block(READ_S),
                    warmup=1, iters=3)
    n_samples = 12 * int(READ_S * REPORT_SPS)
    record("energy/mainboard_read_legacy", t_leg,
           f"{n_samples / t_leg:.0f}samples/s_processed;"
           f"hw_rate={REPORT_SPS}SPS;host={host}")
    record("energy/mainboard_read_columnar", t_col,
           f"{n_samples / t_col:.0f}samples/s_processed;"
           f"speedup={t_leg / t_col:.1f}x_vs_legacy;host={host}")

    t = time_fn(lambda: read_vectorized(lambda x: 95.0, 0.0, 10.0),
                warmup=1, iters=3)
    record("energy/probe_vectorized_10s", t,
           f"{10 * REPORT_SPS / t:.0f}samples/s;res={MILLIWATT * 1e3:.0f}mW;"
           f"host={host}")

    # -- tag attribution: identical streams through both reduction paths ----
    s_leg, s_col = _session(power), _session(power)
    with s_leg.region("fwd"):
        samples = s_leg.board.read_samples(TAG_S)[0]
    with s_col.region("fwd"):
        block = s_col.board.read_block(TAG_S)[0]
    assert np.array_equal([s.watts for s in samples], block.watts), \
        "legacy and columnar reads diverged on identical seeds"

    board = type(s_leg.board)
    t_leg = time_fn(lambda: board.energy_by_tag(samples), warmup=1, iters=5)
    t_col = time_fn(lambda: block.energy_by_tag(), warmup=1, iters=5)
    legacy_by_tag = board.energy_by_tag(samples)
    col_by_tag = block.energy_by_tag()
    err = max(abs(legacy_by_tag[k] - col_by_tag.get(k, 0.0))
              for k in legacy_by_tag)
    assert err < 1e-9, f"energy_by_tag paths disagree by {err} J"
    record("energy/tag_attribution_legacy", t_leg,
           f"grid5000_ratio={REPORT_SPS / 50:.0f}x;host={host}")
    record("energy/tag_attribution_columnar", t_col,
           f"speedup={t_leg / t_col:.1f}x_vs_legacy;match_err={err:.1e}J;"
           f"host={host}")

    # -- end-to-end MonitorSession sampling (the API every consumer uses) ---
    session = MonitorSession(MutableSource(95.0), node="bench",
                             probe_cfg=ProbeConfig())
    t = time_fn(lambda: session.sample(READ_S, tags=("step",)),
                warmup=1, iters=3)
    record("energy/session_sample", t,
           f"{READ_S * REPORT_SPS / t:.0f}samples/s;host={host}")

    # -- trace store: record -> reload round trip ---------------------------
    _bench_tracestore(record, host)
    return rows


if __name__ == "__main__":
    run()
