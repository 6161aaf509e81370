#!/usr/bin/env python3
"""Readings for a cell's correctness limits: for each seed, a short window
of the cell's own traffic through the program, then the comparison of what
it served with the float32 reference (the program's reading and
``correct``) and, over the same prompts and tokens, the fp8 control's
reading and ``correct`` by the same verdict. One process for all seeds, so
the kernels build and the card starts once.

    python3 portbench/control.py --workload <name> --seconds 15 \\
        --seeds 11 12 13 ... [--control-seeds 4] [--fault decode|prefill] \\
        [--out <file>.jsonl]

With ``--fault`` the program runs with a token altered where it is
produced (``faults.py``), for the fault's reading. Not run by the
benchmark's own runs. Each seed's line gives the readings, both verdicts
and the time the reference took.
"""
import argparse
import contextlib
import gc
import json
import sys
import time

import run


def readings(workload: str, seeds, seconds: float, device: str = "cuda",
             control_seeds=None, fault=None):
    """Yield one dict of readings a seed; the control's on the first
    ``control_seeds`` seeds (all with None); with ``fault`` (a place of
    ``faults.PLACES``), the program's tokens altered there."""
    run.prepare()
    import torch
    from portbench import faults, spec
    from portbench.kinds import serve
    bench = spec.load_benchmark(run.ROOT)
    cell = spec.workload(bench, workload)
    cfg = spec.config(bench, cell["config"], run.ROOT)
    mix = spec.traffic(cell["traffic"])
    for i, seed in enumerate(seeds):
        cfg["check"] = dict(cfg["check"], control=control_seeds is None
                            or i < control_seeds)
        t = time.perf_counter()
        with (faults.altered(fault, cfg["model"]["vocab_size"]) if fault
              else contextlib.nullcontext()):
            rec = serve.run(cfg, mix, seed, seconds, trace_on=False,
                            device=device, t0=t)
        ctl = rec["control"] or {}
        yield {"workload": workload, "seed": seed, "fault": fault,
               "correct": rec["correct"],
               "control_correct": ctl.get("correct"), **rec["compare"],
               "reference_s": rec["reference_s"],
               "attempted": rec["attempted"], "failed": rec["failed"],
               "memory_peak_bytes": rec["memory_peak_bytes"],
               "setup_s": rec["setup_s"], "window_s": rec["window_s"],
               "window_tokens": rec["tokens"], "phases": rec["phases"]}
        del rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int,
                    help="run the control on the first N seeds only")
    ap.add_argument("--fault", choices=("decode", "prefill"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("control: no CUDA device")
        return 2
    out = open(args.out, "a") if args.out else None
    for r in readings(args.workload, args.seeds, args.seconds,
                      control_seeds=args.control_seeds, fault=args.fault):
        line = json.dumps(r)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
