"""Trace replay CLI: regression-test admission policies offline.

    PYTHONPATH=src python -m repro_torch.launch.replay trace.dkt \
        --requests 8 --max-new 12 --ttl 0.3 --slots 2 [--json rows.json] \
        [--check-determinism]

Loads a recorded ``.dkt`` trace, rebuilds per-node ``TraceSource`` power,
and drives the serve admission pipeline (baseline work-conserving policy
vs a strict single-slot variant, plus ``--cap`` for DVFS power capping)
through the deterministic replay harness. ``--check-determinism`` replays
everything twice and exits non-zero on any divergence (the CI gate). The
capped policy's power model is the ``H100_SXM`` one, the device the port
serves on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.core.hw import H100_SXM
from repro_torch.core.energy import ServePowerModel
from repro_torch.core.scheduler import ThroughputStats
from repro_torch.serve.queue import AdmissionController
from repro_torch.tracestore import ReplayRequest, replay


def _policies(args):
    out = {"baseline": None,
           "strict-1slot": AdmissionController(
               stats=ThroughputStats(), max_slots_fn=lambda b: 1)}
    if args.cap is not None:
        pm = ServePowerModel(args.cap_params, dev=H100_SXM)
        out[f"cap-{args.cap:.0f}w"] = AdmissionController(
            pm, power_cap_w=args.cap, stats=ThroughputStats())
    return out


def _run(args):
    wl = [ReplayRequest(i, max_new_tokens=args.max_new, ttl_s=args.ttl,
                        arrival_s=i * args.arrival_gap)
          for i in range(args.requests)]
    return replay(args.trace, workload=wl, policies=_policies(args),
                  batch_size=args.slots, step_s=args.step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help=".dkt trace file to replay")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--ttl", type=float, default=None,
                    help="per-request TTL in seconds (enables shedding)")
    ap.add_argument("--arrival-gap", type=float, default=0.02)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--step", type=float, default=0.01,
                    help="simulation tick in seconds")
    ap.add_argument("--cap", type=float, default=None,
                    help="add a DVFS power-capped policy at this wattage")
    ap.add_argument("--cap-params", type=float, default=1e9,
                    help="model size driving the capped policy's power model")
    ap.add_argument("--json", default=None,
                    help="dump the ReplayReport rows as JSON")
    ap.add_argument("--check-determinism", action="store_true",
                    help="replay twice; exit 1 unless reports are identical")
    args = ap.parse_args(argv)

    report = _run(args)
    print(f"replay {report.trace_path}: {report.n_streams} streams, "
          f"{report.n_samples} samples, {report.duration_s:.3f} s")
    for res in report.results:
        print(f"  {res.policy:>14}: {res.attributed_j:9.3f} J attributed "
              f"({res.energy_j:.3f} J trace)  completed={res.completed} "
              f"shed={res.shed}  {res.j_per_token:.4f} J/token"
              + (f"  f={res.dvfs_f_ghz:.2f}GHz" if res.dvfs_f_ghz else ""))
    base = report.results[0].policy
    for res in report.results[1:]:
        d = report.deltas(base, res.policy)
        print(f"  Δ {res.policy} vs {base}: "
              f"{d['attributed_j']:+.3f} J attributed, {d['shed']:+d} shed, "
              f"{d['j_per_token']:+.4f} J/token")

    if args.json:
        rows = {f"replay/{r.policy}": dataclasses.asdict(r)
                for r in report.results}
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2, sort_keys=True)

    if args.check_determinism:
        again = _run(args)
        if again != report:
            print("determinism check FAILED: second replay diverged")
            raise SystemExit(1)
        print("determinism check OK: two replays produced identical reports")
    return report


if __name__ == "__main__":
    main()
