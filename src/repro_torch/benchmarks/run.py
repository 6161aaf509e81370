"""Benchmark harness of the port: one module per paper figure.

Prints ``name,us_per_call,derived`` CSV rows. Runs on the CUDA card unless
asked for the host; with no card and no ``--device cpu`` it fails. The
energy-platform, elastic and scheduler benches run on the host wherever the
others run (their rows name the host CPU).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only <substr>]
        [--device cpu]

``--only checkpoint`` runs the checkpoint I/O bench alone (``--only
bandwidth|peak|launch|energy|elastic|scheduler|serving|roofline`` the
others; serving is ``bench_serving``'s scenarios on the smoke models,
roofline the report of the dry-run's records, which touches no device).
"""
import argparse
import importlib
import sys
import traceback

from repro_torch.core.device import resolve_device

MODULES = [
    ("bandwidth (Fig. 4/6)", "repro_torch.benchmarks.bench_bandwidth"),
    ("peak compute (Fig. 5/7)", "repro_torch.benchmarks.bench_peak"),
    ("launch latency (Fig. 8)", "repro_torch.benchmarks.bench_launch_latency"),
    ("checkpoint I/O (Fig. 9)", "repro_torch.benchmarks.bench_checkpoint_io"),
    ("serving (continuous vs static)", "repro_torch.benchmarks.bench_serving"),
    ("roofline (dry-run)", "repro_torch.benchmarks.bench_roofline"),
    ("energy platform (Sec. 4)", "repro_torch.benchmarks.bench_energy_platform"),
    ("elastic power (Sec. 3.4)", "repro_torch.benchmarks.bench_elastic"),
    ("hetero scheduling (Sec. 6.1)", "repro_torch.benchmarks.bench_scheduler"),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on the host "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("name,us_per_call,derived")
    failures = 0
    for label, mod_name in MODULES:
        if args.only and args.only not in mod_name:
            continue
        print(f"# {label}", file=sys.stderr)
        try:
            importlib.import_module(mod_name).run(dev)
        except Exception:  # noqa: BLE001  (counted: the run exits non-zero)
            failures += 1
            traceback.print_exc()
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
