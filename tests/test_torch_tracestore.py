"""The trace store in both packages, and the ``.dkt`` file as the
interchange between them.

Each test of ``tests/test_tracestore.py`` runs here on the reference and on
the port (``pkg``). Then the cross-package holds: on the same seeded blocks
and meta the two writers (and the two cluster recorders) write the same
bytes; each reader reads the other's file into bit-equal columns; the
port's ``replay`` and ``replay_cluster`` give the reference's results on a
reference recording; the port's engine run, recorded by the port, replays
to its live per-request joules in either package; and the record and replay
CLIs (``--check-determinism``) run as processes on the host.

One fault of the reference shows here: its replay re-clips reports at the
probe's 240 W USB-PD limit, which the live probe's noise (added after the
clip) can exceed by a few mW, so its per-request joules are exact only
below the limit. The port's replay does not re-clip;
``test_reference_replay_reclips_reports_above_the_probe_limit`` pins both.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.models import build_model as jbuild
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.queue import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core import hw as thw
from repro_torch.core.probe import MAX_PD_WATTS
from repro_torch.launch import replay as treplay_cli
from repro_torch.models import build_model as tbuild
from repro_torch.serve.engine import ContinuousEngine, Request

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("repro", "repro_torch")


def _load(root):
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=root, tracestore=mod("tracestore"), telemetry=mod("telemetry"),
        topology=mod("cluster.topology"), probe=mod("core.probe"),
        scheduler=mod("core.scheduler"), queue=mod("serve.queue"))


REF, PORT = _load("repro"), _load("repro_torch")


@pytest.fixture(params=PACKAGES, scope="module")
def pkg(request):
    return _load(request.param)


def assert_block_equal(a, b):
    """Bit-equal columns and segment maps (``a`` and ``b`` may come from
    different packages)."""
    for field in ("t", "volts", "watts", "dt"):
        va, vb = getattr(a, field), getattr(b, field)
        assert va.dtype == vb.dtype == np.float64
        assert np.array_equal(va, vb), field
    assert np.array_equal(a.bits, b.bits)
    assert b.bits.dtype == np.uint8
    assert np.array_equal(a.seg_bounds, b.seg_bounds)
    assert a.seg_maps == b.seg_maps
    assert a.n_avg == b.n_avg


# ---------------------------------------------------------------------------
# format round trip


def random_block(pkg, rng: np.random.Generator, n: int):
    """Random block: empty when n=0, and more distinct tag names than the
    8 GPIO lines (recycled channels: the same line maps to different names
    in different segments)."""
    sb = pkg.telemetry.SampleBlock
    if n == 0:
        return sb.empty()
    t = np.sort(rng.uniform(0.0, 10.0, n))
    k = int(rng.integers(1, min(n, 5) + 1))
    cuts = sorted({0, n, *map(int, rng.integers(1, n, k - 1))}) if n > 1 \
        else [0, n]
    names = [f"region_{i}" for i in range(12)]       # 12 names, 8 lines
    maps = tuple(
        {int(line): names[int(rng.integers(0, len(names)))]
         for line in rng.choice(8, size=int(rng.integers(0, 5)),
                                replace=False)}
        for _ in range(len(cuts) - 1))
    return sb(t=t, volts=np.full(n, 20.0), watts=rng.uniform(0.0, 240.0, n),
              dt=np.full(n, 1e-3),
              bits=rng.integers(0, 256, n).astype(np.uint8),
              seg_bounds=np.asarray(cuts, np.int64), seg_maps=maps)


def _round_trip(pkg, path, rng, ns, n_streams):
    ts = pkg.tracestore
    blocks = [random_block(pkg, rng, n) for n in ns]
    assign = [int(rng.integers(0, n_streams)) for _ in blocks]
    with ts.TraceWriter(path) as w:
        sids = [w.add_stream(f"s{i}", node=f"n{i}", sps=1000.0)
                for i in range(n_streams)]
        for sid_i, block in zip(assign, blocks):
            w.append(sids[sid_i], block)
    with ts.TraceReader(path) as r:
        per_stream = {sid: list(r.blocks(sid)) for sid in sids}
    for sid_i, block in zip(assign, blocks):
        assert_block_equal(block, per_stream[sids[sid_i]].pop(0))
    assert all(not rest for rest in per_stream.values())


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       ns=st.lists(st.integers(0, 40), min_size=1, max_size=4),
       n_streams=st.integers(1, 2))
def test_dkt_round_trip_bit_exact(pkg, tmp_path_factory, seed, ns,
                                  n_streams):
    path = tmp_path_factory.mktemp("dkt") / "roundtrip.dkt"
    _round_trip(pkg, path, np.random.default_rng(seed), ns, n_streams)


def test_dkt_round_trip_bit_exact_seeded(pkg, tmp_path):
    """Seeded sweep of the same property, pinning the empty-block and
    single-sample edge cases."""
    rng = np.random.default_rng(7)
    cases = [[0], [1], [0, 0], [40, 0, 13]]
    cases += [[int(n) for n in rng.integers(0, 40, 3)] for _ in range(10)]
    for case, ns in enumerate(cases):
        _round_trip(pkg, tmp_path / f"rt{case}.dkt", rng, ns,
                    n_streams=1 + case % 2)


def _quiet_session(pkg, watts):
    tel = pkg.telemetry
    return tel.MonitorSession(tel.MutableSource(watts),
                              probe_cfg=pkg.probe.ProbeConfig(noise_w=0.0))


def _write_session(pkg, session, path):
    with pkg.tracestore.TraceWriter(path) as w:
        sid = w.add_stream("n/p0")
        for b in session.blocks():
            w.append(sid, b)
    return sid


def test_dkt_round_trips_recycled_session_channels(pkg, tmp_path):
    """End-to-end: a session that cycles through 3x the GPIO line budget
    round-trips with every segment map (and thus every resolved tag)
    intact."""
    session = _quiet_session(pkg, 42.0)
    for i in range(24):                        # 24 distinct names, 8 lines
        with session.region(f"phase_{i}"):
            session.sample(0.004)
    live = session.block()
    path = tmp_path / "recycled.dkt"
    sid = _write_session(pkg, session, path)
    with pkg.tracestore.TraceReader(path) as r:
        back = r.read(sid)
        assert len(r.tags) == 24
    assert_block_equal(live, back)
    assert live.energy_by_tag() == back.energy_by_tag()
    # the lazy Sample view resolves identical string tuples
    assert [s.tags for s in back.samples()] == [s.tags for s in live.samples()]


def test_reader_time_seek_and_trim(pkg, tmp_path):
    session = _quiet_session(pkg, 100.0)
    for _ in range(10):
        session.sample(0.05)                   # 10 chunks, 50 ms each
    path = tmp_path / "seek.dkt"
    sid = _write_session(pkg, session, path)
    with pkg.tracestore.TraceReader(path) as r:
        assert r.n_samples(sid) == 500
        # seek lands on the chunk covering t (footer index only)
        k = r.seek(sid, 0.26)
        assert r.chunks(sid)[k].t0 <= 0.26 <= r.chunks(sid)[k].t1
        full = r.read(sid)
        part = r.read(sid, t0=0.101, t1=0.3)
        expected = int(((full.t >= 0.101) & (full.t <= 0.3)).sum())
        assert part.n == expected and 198 <= expected <= 201
        assert part.t[0] >= 0.101 and part.t[-1] <= 0.3
        assert part.energy_j() == pytest.approx(100.0 * 0.2, rel=2e-2)


def test_empty_chunk_between_windows_keeps_seek_sorted(pkg, tmp_path):
    """An empty window (sub-grid sample) records t0=t1=0.0; the seek index
    must stay sorted so reads after it don't silently drop samples."""
    session = _quiet_session(pkg, 100.0)
    session.sample(0.05)
    session.sample(0.0004)                     # sub-grid: empty block
    session.sample(0.05)
    assert [b.n for b in session.blocks()] == [50, 0, 50]
    path = tmp_path / "gap.dkt"
    sid = _write_session(pkg, session, path)
    with pkg.tracestore.TraceReader(path) as r:
        part = r.read(sid, t0=0.04)
        full = r.read(sid)
        assert part.n == int((full.t >= 0.04).sum())   # nothing dropped
        assert r.seek(sid, 0.045) == 0


def test_window_spanning_drain_raises(pkg):
    session = _quiet_session(pkg, 10.0)
    session.sample(0.01)
    with pytest.raises(RuntimeError, match="drained"):
        with session.window() as w:
            session.sample(0.01)
            session.drain()                    # recorder flush mid-window
            session.sample(0.01)
            w.report()
    # windows opened after the drain work normally
    with session.window() as w:
        session.sample(0.02)
    assert w.report().n_samples == 20


def test_reader_rejects_garbage(pkg, tmp_path):
    ts = pkg.tracestore
    bad = tmp_path / "bad.dkt"
    bad.write_bytes(b"not a trace at all")
    with pytest.raises(ts.TraceFormatError):
        ts.TraceReader(bad)
    trunc = tmp_path / "trunc.dkt"
    with ts.TraceWriter(trunc) as w:
        sid = w.add_stream("s")
        w.append(sid, pkg.telemetry.SampleBlock.empty())
    data = trunc.read_bytes()
    trunc.write_bytes(data[:-3])               # clip the trailer
    with pytest.raises(ts.TraceFormatError):
        ts.TraceReader(trunc)


# ---------------------------------------------------------------------------
# recording + deterministic replay

NODES = ["az5-a890m-0", "az5-a890m-1"]


def _record_cluster(pkg, path):
    """A short 2-node recording off the paper topology (one probe per chip,
    shared clock, deterministic synthetic power)."""
    topo = pkg.topology.dalek_topology()
    with pkg.tracestore.ClusterRecorder(topo, path, nodes=NODES) as rec:
        for _ in range(8):
            t = rec.cursor
            for j, name in enumerate(NODES):
                node = topo.nodes[name]
                u = 0.5 + 0.5 * np.sin(5.0 * t + j)
                rec.set_power(name, [d.idle_w + (d.tdp_w - d.idle_w) * u
                                     for d in node.spec.devices])
            rec.sample(0.05)
    return path, topo


@pytest.fixture(scope="module")
def recorded_trace(pkg, tmp_path_factory):
    path, topo = _record_cluster(
        pkg, tmp_path_factory.mktemp("trace") / "cluster.dkt")
    return path, topo, NODES


def test_cluster_recorder_streams(pkg, recorded_trace):
    path, topo, nodes = recorded_trace
    with pkg.tracestore.TraceReader(path) as r:
        assert [s["node"] for s in r.streams] == \
            [n for n in nodes for _ in topo.nodes[n].spec.devices]
        for s in r.streams:
            assert s["sps"] == 1000.0          # 2 chips/node: no I2C degrade
            assert r.n_samples(s["id"]) == 400  # 8 windows x 50 ms x 1 kHz
        assert r.meta["kind"] == "cluster"
        assert r.meta["duration_s"] == pytest.approx(0.4)


def _policies(pkg):
    return {"baseline": None,
            "strict": pkg.queue.AdmissionController(
                stats=pkg.scheduler.ThroughputStats(),
                max_slots_fn=lambda b: 1)}


def _workload(pkg):
    return [pkg.tracestore.ReplayRequest(i, max_new_tokens=8, ttl_s=0.1,
                                         arrival_s=0.02 * i)
            for i in range(6)]


def test_replay_policy_deterministic(pkg, recorded_trace):
    path, _, _ = recorded_trace
    replay = pkg.tracestore.replay
    a = replay(path, workload=_workload(pkg), policies=_policies(pkg),
               batch_size=2, step_s=0.01)
    b = replay(path, workload=_workload(pkg), policies=_policies(pkg),
               batch_size=2, step_s=0.01)
    assert a == b                      # same trace -> identical ReplayReport
    assert a.result("baseline").tokens > 0
    assert a.result("baseline").attributed_j > 0
    # the strict policy admits less -> sheds more under TTL pressure
    assert a.deltas("baseline", "strict")["shed"] >= 0
    # injectable max_slots hook actually constrained concurrency
    assert a.result("strict").completed <= a.result("baseline").completed


def test_replay_policy_energy_conserved(pkg, recorded_trace):
    """Attributed joules never exceed the recorded trace energy, and with a
    work-conserving policy the active-window share adds up exactly."""
    path, _, _ = recorded_trace
    ts = pkg.tracestore
    wl = [ts.ReplayRequest(i, max_new_tokens=4) for i in range(4)]
    with ts.TraceReader(path) as r:
        res = ts.replay_policy(r, wl, batch_size=4, step_s=0.01)
        total = sum(r.read(s["id"]).energy_j() for s in r.streams)
    assert res.attributed_j <= total + 1e-9
    assert res.attributed_j == pytest.approx(
        sum(j for _, j in res.per_request_j))


JOBS = [{"user": "u1", "partition": "az5-a890m", "n_nodes": 2,
         "duration_s": 0.2, "submit_s": 0.0}]


def test_replay_cluster_jobs_debit_recorded_power(pkg, recorded_trace):
    path, topo, _ = recorded_trace
    rep = pkg.tracestore.replay(path, topo=topo, cluster_jobs=JOBS)
    assert len(rep.cluster_jobs) == 1
    job = rep.cluster_jobs[0]
    assert job.state == "DONE"
    assert job.energy_j > 0            # measured joules, not TDP guesses


# ---------------------------------------------------------------------------
# the .dkt file between the packages


def _seeded_blocks(seed):
    """The same seeded blocks in each package's ``SampleBlock``."""
    ns = [37, 0, 1, 40, 12]
    return {p.name: [random_block(p, np.random.default_rng(seed + i), n)
                     for i, n in enumerate(ns)] for p in (REF, PORT)}


META = {"run": "cross", "grid_sps": 1000.0, "nested": {"a": [1, 2.5, None]}}


def _write(pkg, path, blocks):
    with pkg.tracestore.TraceWriter(path, meta=META) as w:
        sids = [w.add_stream("n0/chip0", node="n0", sps=1000.0, volts=20.0),
                w.add_stream("n1/chip0", node="n1", sps=500.0)]
        for i, b in enumerate(blocks):
            w.append(sids[i % 2], b)
    return path


@pytest.mark.parametrize("seed", [0, 11])
def test_port_writer_writes_the_reference_bytes(tmp_path, seed):
    blocks = _seeded_blocks(seed)
    ref = _write(REF, tmp_path / "ref.dkt", blocks["repro"])
    port = _write(PORT, tmp_path / "port.dkt", blocks["repro_torch"])
    assert port.read_bytes() == ref.read_bytes()


def test_port_cluster_recorder_writes_the_reference_bytes(tmp_path):
    ref, _ = _record_cluster(REF, tmp_path / "ref.dkt")
    port, _ = _record_cluster(PORT, tmp_path / "port.dkt")
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["port-reads-reference", "reference-reads-port"])
def test_each_reader_reads_the_other_packages_file(tmp_path, writer,
                                                   reader):
    blocks = _seeded_blocks(5)
    path = _write(writer, tmp_path / "x.dkt", blocks[writer.name])
    with reader.tracestore.TraceReader(path) as r:
        assert r.meta == META and r.version == 1
        got = [list(r.blocks(sid)) for sid in r.stream_ids()]
        whole = r.read(0)
    want = blocks[writer.name]
    for i, b in enumerate(want):
        assert_block_equal(b, got[i % 2][i // 2])
    assert_block_equal(writer.telemetry.SampleBlock.concat(want[0::2]),
                       whole)


def test_port_replay_is_the_reference_on_a_reference_trace(tmp_path):
    path, _ = _record_cluster(REF, tmp_path / "ref.dkt")
    reports = []
    for p in (REF, PORT):
        rep = p.tracestore.replay(
            path, workload=_workload(p), policies=_policies(p),
            batch_size=2, step_s=0.01,
            topo=p.topology.dalek_topology(), cluster_jobs=JOBS)
        with p.tracestore.TraceReader(path) as r:
            jobs = p.tracestore.replay_cluster(
                r, p.topology.dalek_topology(), JOBS + [
                    dict(JOBS[0], user="u2", n_nodes=1, submit_s=0.1)])
        reports.append((dataclasses.asdict(rep),
                        [dataclasses.asdict(j) for j in jobs]))
    assert reports[1] == reports[0]
    assert reports[1][0]["results"][0]["attributed_j"] > 0
    assert len(reports[1][1]) == 2


# ---------------------------------------------------------------------------
# a live engine run -> record -> replay attribution (the acceptance bar)


def _port_serve(dev, path):
    """granite-20b smoke in f32 on the host through the port's continuous
    engine with the power model of ``dev``, recorded by the port."""
    cfg = tconfigs.get_smoke("granite-20b").replace(dtype="float32")
    model = tbuild(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, "cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=3 + (i % 3) * 3) for i in range(5)]
    eng = ContinuousEngine(model, params, batch_size=3, max_seq=48, dev=dev)
    eng.serve(reqs)
    PORT.tracestore.record_engine(eng.tel, path)
    return path, {r.req_id: r.energy_j for r in reqs}


@pytest.fixture(scope="module")
def port_serves(tmp_path_factory):
    """One recorded port run on the H100 power model (its reports sit at
    the probe's 240 W limit) and one on the paper's Radeon 890M iGPU
    (3-30 W, below it)."""
    d = tmp_path_factory.mktemp("serve")
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # smoke sizes; several test processes
    try:
        yield {name: _port_serve(getattr(thw, name), d / f"{name}.dkt")
               for name in ("H100_SXM", "RADEON_890M")}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("replayer,dev", [
    (PORT, "H100_SXM"), (PORT, "RADEON_890M"), (REF, "RADEON_890M")],
    ids=["port-H100_SXM", "port-RADEON_890M", "reference-RADEON_890M"])
def test_engine_attribution_replays_exactly(port_serves, replayer, dev):
    path, live = port_serves[dev]
    ts = replayer.tracestore
    with ts.TraceReader(path) as r:
        replayed = ts.replay_attribution(r)
    with ts.TraceReader(path) as r:
        replayed_again = ts.replay_attribution(r)
    assert set(replayed) == {rid for rid, j in live.items() if j > 0}
    for rid, j in replayed.items():
        assert abs(j - live[rid]) < 1e-6          # acceptance: within 1e-6 J
    assert replayed == replayed_again              # deterministic replay


def test_reference_replay_reclips_reports_above_the_probe_limit(tmp_path):
    """The reference's own engine on the H100's power values, recorded by
    the reference: its replay misses the live joules by more than 1e-6 J,
    because the live reports at the 240 W limit carry probe noise above
    it and the replayed probe clips them again; the port's replay of the
    same trace gives the live joules."""
    cfg = jconfigs.get_smoke("granite-20b")
    model = jbuild(cfg, q_block=8)
    params, _ = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    reqs = [JRequest(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                     max_new_tokens=3 + (i % 3) * 3) for i in range(5)]
    dev = jhw.DeviceSpec(**dataclasses.asdict(thw.H100_SXM))
    eng = JEngine(model, params, batch_size=3, max_seq=48, dev=dev)
    eng.serve(reqs)
    path = tmp_path / "serve.dkt"
    REF.tracestore.record_engine(eng.tel, path)
    live = {r.req_id: r.energy_j for r in reqs}
    errs = {}
    for p in (REF, PORT):
        with p.tracestore.TraceReader(path) as r:
            got = p.tracestore.replay_attribution(r)
            watts = r.read(0).watts
        errs[p.name] = max(abs(got[rid] - j) for rid, j in live.items())
    assert (watts > MAX_PD_WATTS).any()
    assert errs["repro_torch"] < 1e-6
    assert errs["repro"] > 1e-6


# ---------------------------------------------------------------------------
# the CLIs


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_record_then_replay_cli_check_determinism(tmp_path):
    trace = tmp_path / "t.dkt"
    rec = _cli("repro_torch.launch.record", "--out", str(trace), "--nodes",
               "2", "--duration", "0.5")
    assert rec.returncode == 0, rec.stderr
    assert "4 streams, 2000 samples" in rec.stdout
    rep = _cli("repro_torch.launch.replay", str(trace), "--ttl", "0.3",
               "--cap", "150", "--check-determinism")
    assert rep.returncode == 0, rep.stderr
    assert "determinism check OK" in rep.stdout
    assert "cap-150w" in rep.stdout
    # without the capped policy (the reference's is on the TPU v5e model,
    # the port's on the H100's) both CLIs write the same rows
    rows = {}
    for name, cli in (("repro", "repro.launch.replay"),
                      ("repro_torch", "repro_torch.launch.replay")):
        importlib.import_module(cli).main(
            [str(trace), "--ttl", "0.3", "--json", str(tmp_path / name)])
        rows[name] = json.loads((tmp_path / name).read_text())
    assert rows["repro_torch"] == rows["repro"]
    assert set(rows["repro"]) == {"replay/baseline", "replay/strict-1slot"}


def test_replay_cli_exits_1_when_two_replays_differ(tmp_path, monkeypatch):
    path, _ = _record_cluster(PORT, tmp_path / "t.dkt")
    real = treplay_cli.replay
    calls = []

    def drifting(*args, **kw):
        rep = real(*args, **kw)
        calls.append(rep)
        return dataclasses.replace(rep, n_samples=rep.n_samples + len(calls))

    monkeypatch.setattr(treplay_cli, "replay", drifting)
    with pytest.raises(SystemExit) as exc:
        treplay_cli.main([str(path), "--check-determinism"])
    assert exc.value.code == 1 and len(calls) == 2
