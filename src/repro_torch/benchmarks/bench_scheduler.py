"""Paper Sec. 6.1 (HCW'25 use case): heterogeneous two-resource scheduling.

Task chains placed across p-core/e-core classes under time vs energy vs EDP
objectives; derived column compares against the best single-class baseline.

A host bench, as in the reference (the list scheduler runs on the host):
the derived column names the host CPU (``common.host_cpu``), never the
card. ``device`` is taken for the runner's sake and not used.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_scheduler
"""
from repro_torch.benchmarks.common import BenchRows, host_cpu, time_fn
from repro_torch.core import hw
from repro_torch.core.scheduler import (HeterogeneousScheduler,
                                        ResourceClass, Task)


def run(device=None):
    rows = BenchRows()
    host = host_cpu()
    classes = [
        ResourceClass("p-cores", hw.RYZEN_7945HX, 4, efficiency=0.8),
        ResourceClass("e-cores", hw.RYZEN_AI_HX370, 8, efficiency=0.7),
    ]
    tasks = []
    for c in range(4):  # four chains of six tasks
        for i in range(6):
            deps = (f"c{c}t{i-1}",) if i else ()
            tasks.append(Task(f"c{c}t{i}", flops=2e12, deps=deps))

    for obj in ("time", "energy", "edp"):
        sched = HeterogeneousScheduler(classes, obj)
        t = time_fn(lambda: sched.schedule(tasks), warmup=0, iters=3)
        _, stats = sched.schedule(tasks)
        base = HeterogeneousScheduler(classes[:1], "time")
        _, bstats = base.schedule(tasks)
        speedup = bstats["makespan_s"] / stats["makespan_s"]
        rows.record(f"sched/{obj}", t,
                    f"makespan={stats['makespan_s']:.1f}s;"
                    f"energy={stats['energy_j']:.0f}J;"
                    f"vs_pcore_only={speedup:.2f}x;host={host}")
    return rows


if __name__ == "__main__":
    run()
