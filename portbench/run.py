#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for. The cell's traffic names its kind (``kinds/<kind>.py``), which
sets up the program, measures for ``--seconds`` and checks what it served.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (and the device's busy and traced
seconds, and a breakdown). The numbers compared to decide ``correct``
close standard error and the result line, each beside its limit.

Every cache of the program and of PyTorch goes to a fixed directory under
``build/`` in the checkout. The run exits non-zero, printing no result,
without the cards, or if JAX or the JAX package is loaded once every metric
has been read, just before the result would print.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare():
    """Point every cache at a fixed directory under the checkout's
    ``build/``, and put the checkout and its ``src`` on the path. Call
    before importing torch or the program."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info(torch, chips: int, rec, trace: bool):
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    if trace:
        sessions = rec["sessions"]
        info["busy_s"] = sum(s["busy_s"] for s in sessions)
        info["window_s"] = sum(s["span_s"] for s in sessions)
    return info


def breakdown(rec):
    from portbench import trace as tr
    return {"device_ops": tr.top(tr.kernel_seconds(rec["sessions"])),
            "idle_gaps": tr.top(tr.idle_by_span(rec["sessions"],
                                                rec["spans"]))}


def energy_meter(torch):
    from portbench import nvml
    try:
        return nvml.Nvml(str(torch.cuda.get_device_properties(0).uuid))
    except (OSError, RuntimeError, AttributeError) as e:
        log(f"portbench: the card's energy counter does not read ({e}); "
            "no energy metric")
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()
    from portbench import spec
    bench = spec.load_benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    import torch
    torch.set_num_threads(2)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
            f"device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cfg = spec.config(bench, cell["config"], ROOT)
    mix = spec.traffic(cell["traffic"])
    meter = energy_meter(torch)
    limit_w = meter.power_limit_w() if meter is not None else None
    log(f"portbench: {cell['name']} seed {args.seed} on "
        f"{torch.cuda.get_device_name(0)}, power limit {limit_w} W")
    kind = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    rec = kind.run(cfg, mix, args.seed, args.seconds,
                     trace_on=bool(args.trace), device="cuda", t0=T0,
                     energy=meter)
    metrics = spec.read_metrics(spec.cell_metrics(bench, cell["name"],
                                                  bool(args.trace)), rec)
    n_ttft = sum(1 for r in rec["requests"] if r["ttft_s"] is not None)
    log(f"portbench: window {rec['window_s']:.3f} s, {rec['attempted']} "
        f"requests sent ({n_ttft} with a first token, the p95's sample), "
        f"{rec['failed']} failed, {rec['tokens']} tokens delivered; "
        f"set-up {rec['setup_s']:.3f} s, reference {rec['reference_s']:.1f} "
        f"s; set-up parts {rec['setup_parts']}; compare {rec['compare']}; "
        f"window phases {rec['phases']}; "
        f"power limit {limit_w} W")
    if args.trace:
        log(f"portbench: {len(rec['sessions'])} of {rec['sessions_tried']} "
            f"profiler sessions whole; flash {rec['flash']}")
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": device_info(torch, cell["chips"], rec, args.trace)}
    if args.trace and rec["sessions"]:
        out["breakdown"] = breakdown(rec)
    out["checks"] = rec["checks"]
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the run loaded {bad}; no result")
        return 3
    for name, c in rec["checks"].items():
        rel = "at least" if name == "checked_tokens" else "at most"
        log(f"check {name}: {c['value']} ({rel} {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
