"""Cluster trace recording CLI.

    PYTHONPATH=src python -m repro_torch.launch.record --out trace.dkt \
        --partition az5-a890m --nodes 2 --duration 1.0 --step 0.05

Attaches one probe per chip on each selected node of the paper's topology
(``ClusterRecorder``), drives every chip with a deterministic synthetic
utilization schedule (idle..TDP sinusoid, per-node phase offset), and
writes one multi-stream ``.dkt`` trace. The output replays with
``python -m repro_torch.launch.replay``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.cluster.topology import dalek_topology
from repro_torch.tracestore import ClusterRecorder, TraceReader


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="trace.dkt")
    ap.add_argument("--partition", default="az5-a890m",
                    help="paper partition to record from")
    ap.add_argument("--nodes", type=int, default=2,
                    help="number of nodes (probed one session each)")
    ap.add_argument("--duration", type=float, default=1.0,
                    help="recording length in seconds (session clock)")
    ap.add_argument("--step", type=float, default=0.05,
                    help="host power-update period (one window per step)")
    ap.add_argument("--util-hz", type=float, default=3.0,
                    help="synthetic utilization oscillation rate")
    args = ap.parse_args(argv)

    topo = dalek_topology()
    names = topo.partition_nodes(args.partition)[:args.nodes]
    if len(names) < args.nodes:
        raise SystemExit(f"partition {args.partition} has only "
                         f"{len(names)} nodes")

    with ClusterRecorder(topo, args.out, nodes=names,
                         meta={"workload": "synthetic-sin",
                               "partition": args.partition}) as rec:
        energy = 0.0
        while rec.cursor < args.duration - 1e-12:
            t = rec.cursor
            for j, name in enumerate(names):
                node = topo.nodes[name]
                u = 0.5 + 0.5 * np.sin(args.util_hz * t + j)
                rec.set_power(name, [d.idle_w + (d.tdp_w - d.idle_w) * u
                                     for d in node.spec.devices])
            energy += rec.sample(min(args.step, args.duration - t),
                                 tags=("record",))
        path = rec.close()

    with TraceReader(path) as r:
        print(f"recorded {path}: {len(r.streams)} streams, "
              f"{r.n_samples()} samples, {os.path.getsize(path)} bytes")
        for s in r.streams:
            t0, t1 = r.time_range(s["id"])
            print(f"  stream {s['id']}: {s['name']} ({s['device']}) "
                  f"sps={s['sps']:.0f} span=[{t0:.3f}, {t1:.3f}]s")
    print(f"cluster energy: {energy:.3f} J over {args.duration:.3f} s")
    return path


if __name__ == "__main__":
    main()
