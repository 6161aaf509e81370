"""Paper Sec. 3.4 (Tab. 2): elastic power management over a simulated day.

A bursty job arrival pattern on the DALEK cluster; derived column = energy
with suspend/resume vs always-idle baseline, and the idle-cluster wattage
(paper claims ~50 W with nodes off).

A host bench, as in the reference (the cluster manager is a simulation on
the host): the derived column names the host CPU (``common.host_cpu``),
never the card. ``device`` is taken for the runner's sake and not used.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_elastic
"""
from repro_torch.benchmarks.common import BenchRows, host_cpu, time_fn
from repro_torch.cluster.manager import ClusterManager
from repro_torch.cluster.topology import dalek_topology
from repro_torch.core import hw


def _simulate():
    cm = ClusterManager(dalek_topology())
    arrivals = [(h * 3600.0, "az4-n4090", 2, 1800.0) for h in (1, 3, 9)]
    arrivals += [(2 * 3600.0, "az5-a890m", 4, 7200.0)]
    t = 0.0
    for at, part, n, dur in arrivals:
        cm.advance(at - t)
        cm.submit("user", part, n, dur)
        t = at
    cm.advance(24 * 3600.0 - t)
    return cm


def run(device=None):
    rows = BenchRows()
    t = time_fn(_simulate, warmup=0, iters=1)
    cm = _simulate()
    e_elastic = cm.elastic.total_energy_j()
    # baseline: all nodes idle all day
    idle_w = sum(p.idle_w for p in hw.DALEK_PARTITIONS.values())
    e_idle = idle_w * 24 * 3600
    saved = 1 - (e_elastic / e_idle)
    rows.record("elastic/day_sim", t,
                f"saved={saved * 100:.0f}%;"
                f"idle_cluster={hw.cluster_idle_w('off'):.0f}W;"
                f"host={host_cpu()}")
    return rows


if __name__ == "__main__":
    run()
