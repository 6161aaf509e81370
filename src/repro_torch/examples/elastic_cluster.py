"""Elastic cluster simulation (paper Sec. 3.4): a day of bursty jobs on the
DALEK topology with WoL resume + 10-min idle power-off, energy quotas
(Sec. 6.2) and login policy (Sec. 3.5).

    PYTHONPATH=src python -m repro_torch.examples.elastic_cluster

A simulation on the host: it takes no device. Returns the manager.
"""
import argparse

from repro_torch.cluster.manager import ClusterManager
from repro_torch.cluster.topology import dalek_topology
from repro_torch.core import hw


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)
    cm = ClusterManager(dalek_topology())
    cm.set_quota("grad_student", energy_j=5e7)    # ~14 kWh... generous
    print(f"idle cluster (nodes off): {hw.cluster_idle_w('off'):.0f} W "
          f"(paper claims ~50 W)")

    j1 = cm.submit("grad_student", "az4-n4090", 2, 3600.0)
    print(f"job {j1.job_id}: {j1.state} on {j1.nodes} "
          f"(boot delay {j1.start_t - cm.elastic.t:.0f}s <= 120s)")
    cm.advance(130.0)
    print(f"  t+130s: {cm.jobs[j1.job_id].state}; "
          f"login allowed: {cm.can_login('grad_student', j1.nodes[0])}; "
          f"stranger: {cm.can_login('stranger', j1.nodes[0])}")
    cm.advance(3600.0)
    j = cm.jobs[j1.job_id]
    print(f"  done: {j.state}, energy {j.energy_j/3.6e6:.2f} kWh; "
          f"quota used {cm.quota('grad_student').used_energy_j/3.6e6:.2f} kWh")

    cm.advance(700.0)   # > 10 min idle -> nodes power off
    states = cm.elastic.states()
    print(f"after idle timeout: {set(states[n] for n in j.nodes)}")
    day_j = cm.elastic.total_energy_j()
    # fair baseline: same job energy, but all 16 nodes sit idle when unused
    # instead of powering off
    idle_day = (sum(p.idle_w for p in hw.DALEK_PARTITIONS.values())
                * cm.elastic.t + j.energy_j)
    print(f"energy so far {day_j/3.6e6:.2f} kWh vs always-on baseline "
          f"{idle_day/3.6e6:.2f} kWh -> saved "
          f"{(1 - day_j/idle_day)*100:.0f}%")
    return cm


if __name__ == "__main__":
    main()
