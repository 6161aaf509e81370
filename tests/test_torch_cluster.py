"""The cluster layer in both packages: elasticity (paper Sec. 3.4), the
SLURM-like manager, quotas (Sec. 6.2), heterogeneous scheduling (Sec. 6.1)
and the topology (Sec. 2). Each test of ``tests/test_cluster.py`` runs here
on the reference and on the port (``pkg``); the fault-tolerance tests of that
file run on the port in ``tests/test_torch_examples.py``. Then the port is
held to the reference's numbers on the paper's partitions: the device and
partition tables, ``cluster_idle_w``, the scheduler's placements and
stats, ``proportional_split`` and the straggler mitigator."""
import dataclasses
import importlib
import types

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _load(root):
    mods = ("core.hw", "core.elastic", "core.scheduler", "cluster.manager",
            "cluster.topology")
    return types.SimpleNamespace(**{
        m.split(".")[1]: importlib.import_module(f"{root}.{m}")
        for m in mods})


@pytest.fixture(params=PACKAGES, scope="module")
def pkg(request):
    return _load(request.param)


REF, PORT = _load("repro"), _load("repro_torch")


def _nodes(pkg, n=4):
    part = pkg.hw.DALEK_PARTITIONS["az4-n4090"]
    return {f"n{i}": part.node for i in range(n)}


# ---------------------------------------------------------------------------
# elasticity


def test_idle_timeout_powers_off(pkg):
    el = pkg.elastic
    ec = el.ElasticController(_nodes(pkg, 2))
    ec.resume(["n0", "n1"])
    ec.advance(130.0)                       # boot (120s) + idle begins
    assert ec.nodes["n0"].state == el.PowerState.IDLE
    ec.advance(el.IDLE_OFF_S + 1)
    assert ec.nodes["n0"].state == el.PowerState.OFF
    assert ec.total_power_w() == 0.0


def test_boot_latency_within_paper_bound(pkg):
    ec = pkg.elastic.ElasticController(_nodes(pkg, 1))
    ready = ec.resume(["n0"])
    assert ready - ec.t <= 120.0            # paper: up to 2 min


def test_busy_nodes_never_time_out(pkg):
    el = pkg.elastic
    ec = el.ElasticController(_nodes(pkg, 1))
    ec.resume(["n0"])
    ec.advance(125.0)
    ec.mark_busy(["n0"])
    ec.advance(el.IDLE_OFF_S * 3)
    assert ec.nodes["n0"].state == el.PowerState.BUSY


def test_energy_integration(pkg):
    ec = pkg.elastic.ElasticController(_nodes(pkg, 1), idle_off_s=1e9)
    ec.resume(["n0"])
    ec.advance(120.0)                       # booting at idle power
    e_boot = ec.total_energy_j()
    assert abs(e_boot - 120.0 * 53.0) < 1.0
    ec.mark_busy(["n0"])
    ec.advance(10.0)
    assert abs(ec.total_energy_j() - e_boot - 10 * 525.0) < 1.0


# ---------------------------------------------------------------------------
# manager


def _manager(pkg):
    return pkg.manager.ClusterManager(pkg.topology.dalek_topology())


def test_job_lifecycle_with_wol(pkg):
    cm = _manager(pkg)
    job = cm.submit("alice", "az4-n4090", 2, duration_s=100.0)
    assert job.state == "CONFIGURING"       # nodes were off -> booting
    cm.advance(125.0)
    assert cm.jobs[job.job_id].state == "RUNNING"
    assert cm.can_login("alice", job.nodes[0])
    assert not cm.can_login("bob", job.nodes[0])
    cm.advance(100.0)
    assert cm.jobs[job.job_id].state == "DONE"
    assert not cm.can_login("alice", job.nodes[0])
    # scratch survives job end (paper Sec. 3.5)
    assert "alice" in cm.scratch[job.nodes[0]]


def test_pending_when_partition_full(pkg):
    cm = _manager(pkg)
    cm.submit("a", "az4-a7900", 4, 50.0)
    j2 = cm.submit("b", "az4-a7900", 2, 50.0)
    assert j2.state == "PENDING"
    cm.advance(300.0)                       # j1 boots+runs+finishes
    assert cm.jobs[j2.job_id].state in ("RUNNING", "CONFIGURING", "DONE")


def test_energy_quota_enforced(pkg):
    cm = _manager(pkg)
    cm.set_quota("carol", energy_j=1.0)     # 1 J: exhausted by any job
    j1 = cm.submit("carol", "az5-a890m", 1, 10.0)
    cm.advance(200.0)
    assert cm.jobs[j1.job_id].state == "DONE"
    assert not cm.quota("carol").ok()
    j2 = cm.submit("carol", "az5-a890m", 1, 10.0)
    assert j2.state == "FAILED"


def test_idle_cluster_power_near_50w(pkg):
    cm = _manager(pkg)
    # all compute nodes start OFF: the manager adds nothing; frontend etc.
    # are outside compute management — paper's ~50 W claim
    assert cm.cluster_power_w() == 0.0
    assert 40 <= pkg.hw.cluster_idle_w("off") <= 60


def test_munge_credentials(pkg):
    cm = _manager(pkg)
    tok = cm.credential("dave")
    assert cm.validate(tok) == "dave"
    assert cm.validate("bogus") is None


# ---------------------------------------------------------------------------
# heterogeneous scheduling (Sec. 6.1)


def _classes(pkg):
    rc, hw = pkg.scheduler.ResourceClass, pkg.hw
    return [rc("p-cores", hw.RYZEN_7945HX, 4, efficiency=0.8),
            rc("e-cores", hw.RYZEN_AI_HX370, 8, efficiency=0.7)]


def _chain(pkg, n=6, flops=1e12):
    return [pkg.scheduler.Task(f"t{i}", flops=flops,
                               deps=(f"t{i-1}",) if i else ())
            for i in range(n)]


def test_chain_scheduling_objectives_differ(pkg):
    hs = pkg.scheduler.HeterogeneousScheduler
    tasks = _chain(pkg)
    _, time_stats = hs(_classes(pkg), "time").schedule(tasks)
    _, energy_stats = hs(_classes(pkg), "energy").schedule(tasks)
    assert time_stats["makespan_s"] <= energy_stats["makespan_s"] + 1e-9
    assert energy_stats["energy_j"] <= time_stats["energy_j"] + 1e-9


def test_parallel_tasks_use_both_classes(pkg):
    tasks = [pkg.scheduler.Task(f"p{i}", flops=1e12) for i in range(8)]
    placements, _ = pkg.scheduler.HeterogeneousScheduler(
        _classes(pkg), "time").schedule(tasks)
    assert {p.resource for p in placements} == {"p-cores", "e-cores"}


def test_proportional_split_properties(pkg):
    ws = pkg.scheduler.WorkerStats
    split = pkg.scheduler.proportional_split(
        1000, [ws("fast", 100.0), ws("slow", 25.0)])
    assert sum(split.values()) == 1000
    assert split["fast"] == 800 and split["slow"] == 200


def test_straggler_mitigation_rebalances(pkg):
    sm = pkg.scheduler.StragglerMitigator(["a", "b"], threshold=0.05)
    for _ in range(5):
        sm.observe("a", 100, 1.0)
        sm.observe("b", 100, 4.0)           # b is 4x slower
    assert sm.should_resplit({"a": 500, "b": 500})
    split = sm.current_split(1000)
    assert split["a"] == 800 and split["b"] == 200
    # critical path improves ~1.6x
    t_before = 500 / 25.0
    t_after = max(split["a"] / 100.0, split["b"] / 25.0)
    assert t_before / t_after > 1.5


# ---------------------------------------------------------------------------
# topology (Sec. 2)


def test_dalek_topology_matches_paper(pkg):
    topo = pkg.topology.dalek_topology()
    assert len(topo.nodes) == 16             # 4 partitions x 4 nodes
    assert pkg.topology.validate_addressing(topo)
    assert topo.nodes["iml-ia770-0"].spec.net_gbps == 5.0
    assert topo.nodes["az4-n4090-0"].spec.net_gbps == 2.5
    assert topo.nodes["az4-n4090-0"].ip == "192.168.1.1"
    assert topo.nodes["iml-ia770-0"].ip == "192.168.1.65"


def test_bisection_slow_network(pkg):
    topo = pkg.topology.dalek_topology()
    part = topo.partition_nodes("az4-n4090")
    # 4 nodes x 2.5 GbE = 10 Gbps max in/out of a partition: the paper's
    # "network saturates quickly" lesson
    assert topo.bisection_gbps(part) == 10.0


# ---------------------------------------------------------------------------
# the port against the reference's numbers on the paper's partitions

PAPER_DEVICES = ("RYZEN_7945HX", "CORE_ULTRA_185H", "RYZEN_AI_HX370",
                 "CORE_I9_13900H", "RTX_4090", "RX_7900XTX", "ARC_A770",
                 "RADEON_890M")


def test_hw_tables_are_the_reference_tables():
    ref_fields = [f.name for f in dataclasses.fields(REF.hw.DeviceSpec)]
    assert [f.name for f in dataclasses.fields(PORT.hw.DeviceSpec)] \
        == ref_fields
    for name in PAPER_DEVICES:
        assert dataclasses.astuple(getattr(PORT.hw, name)) \
            == dataclasses.astuple(getattr(REF.hw, name)), name
    assert {k: dataclasses.astuple(v)
            for k, v in PORT.hw.DALEK_PARTITIONS.items()} \
        == {k: dataclasses.astuple(v)
            for k, v in REF.hw.DALEK_PARTITIONS.items()}
    assert dataclasses.astuple(PORT.hw.FRONTEND) \
        == dataclasses.astuple(REF.hw.FRONTEND)
    for const in ("SWITCH_IDLE_W", "SWITCH_TDP_W", "RPI_IDLE_W",
                  "RPI_TDP_W", "N_RPI", "PAPER_TOTALS"):
        assert getattr(PORT.hw, const) == getattr(REF.hw, const), const
    # the port's own device keeps its place and values
    assert dataclasses.astuple(PORT.hw.H100_SXM) == (
        "H100 SXM", "nvidia", "gpu", 989e12, "bf16", 3.35e12, 80, 700,
        73.64, 1.98, 0.345)
    assert not any(n.startswith("TPU") or n == "tpu_pod_partition"
                   for n in vars(PORT.hw))


@pytest.mark.parametrize("mode", ["off", "suspend", "idle"])
def test_cluster_idle_w_is_the_reference(mode):
    assert PORT.hw.cluster_idle_w(mode) == REF.hw.cluster_idle_w(mode)


def test_topology_is_the_reference():
    def rows(topo):
        return ({n: (v.partition, v.ip, v.switch_port,
                     dataclasses.astuple(v.spec))
                 for n, v in topo.nodes.items()},
                [dataclasses.astuple(link) for link in topo.links],
                topo.partitions)
    assert rows(PORT.topology.dalek_topology()) \
        == rows(REF.topology.dalek_topology())
    assert not hasattr(PORT.topology, "tpu_topology")


def _tasks(pkg, seed):
    """Four chains of six tasks (bench_scheduler's shape), flops from a
    seed, plus a few independent tasks."""
    rng = np.random.default_rng(seed)
    task = pkg.scheduler.Task
    out = [task(f"c{c}t{i}", flops=float(rng.uniform(1e11, 4e12)),
                deps=(f"c{c}t{i-1}",) if i else ())
           for c in range(4) for i in range(6)]
    out += [task(f"p{i}", flops=float(rng.uniform(1e11, 4e12)),
                 replicable=bool(i % 2)) for i in range(5)]
    return out


@pytest.mark.parametrize("objective", ["time", "energy", "edp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_placements_and_stats_are_the_reference(objective, seed):
    out = []
    for pkg in (REF, PORT):
        placements, stats = pkg.scheduler.HeterogeneousScheduler(
            _classes(pkg), objective).schedule(_tasks(pkg, seed))
        out.append(([dataclasses.astuple(p) for p in placements], stats))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(4))
def test_proportional_split_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.5, 200.0, int(rng.integers(2, 7)))
    total, quantum = int(rng.integers(1, 5000)), int(rng.integers(1, 9))
    splits = [pkg.scheduler.proportional_split(
        total, [pkg.scheduler.WorkerStats(f"w{i}", float(r))
                for i, r in enumerate(rates)], quantum)
        for pkg in (REF, PORT)]
    assert splits[0] == splits[1]
    assert sum(splits[1].values()) == total


def test_throughput_stats_and_straggler_mitigator_keep_one_ewma():
    """``ThroughputStats`` is the mitigator's EWMA keyed by phase: the same
    observations give the same rates, in the port as in the reference."""
    rng = np.random.default_rng(3)
    obs = [(str(rng.choice(["a", "b"])), int(rng.integers(1, 500)),
            float(rng.uniform(0.01, 2.0))) for _ in range(40)]
    rates = []
    for pkg in (REF, PORT):
        ts = pkg.scheduler.ThroughputStats(alpha=0.3)
        sm = pkg.scheduler.StragglerMitigator(["a", "b"], alpha=0.3)
        for name, items, secs in obs:
            ts.observe(name, items, secs)
            sm.observe(name, items, secs)
        assert ts.rates == sm.rates
        rates.append((ts.rates, sm.current_split(1000, quantum=4),
                      sm.should_resplit({"a": 500, "b": 500})))
    assert rates[0] == rates[1]
