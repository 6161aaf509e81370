"""How many of a profiler session's records kineto keeps, against the
process's age (card only).

One bf16 flash call (q, k, v ``[1, 16, 256, 128]``) is profiled 30 times a
session (``common.profiler_session``: ``LEAD`` markers, the calls, ``TAIL``
markers) with each host wait in ``--settle`` before the first marker, once
at the start and then after every ``--every`` seconds of bf16 8192^3
matmuls, until ``--seconds`` have passed. Each line gives the age, the
wait, the markers kept of ``LEAD + TAIL`` and the calls' kernels kept of
30. ``common.LEAD`` is sized from what this showed.

Run: ``PYTHONPATH=src python -m repro_torch.benchmarks.profiler_probe``
(~8 min with the defaults).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks.common import (LEAD, MARKER, TAIL,
                                           profiler_session)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=420.0)
    ap.add_argument("--every", type=float, default=40.0)
    ap.add_argument("--settle", default="0,0.05,0.5",
                    help="host waits (s) before the first marker, a session "
                         "each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: no CUDA device")
    from repro_torch.kernels.flash_attention import ops
    settles = [float(x) for x in args.settle.split(",")]
    q, k, v = (torch.randn(1, 16, 256, 128, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))

    def call():
        return ops.flash_attention(q, k, v)

    call()
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    print(f"{torch.cuda.get_device_name(0)}; {LEAD} + {TAIL} markers, 30 "
          f"calls a session", flush=True)
    while True:
        for settle in settles:
            events = profiler_session(call, 30, settle)
            marks = sum(MARKER in name for _, name, _ in events)
            print(f"age {time.perf_counter() - t0:.0f} s, settle {settle} s: "
                  f"markers {marks} of {LEAD + TAIL}, kernels "
                  f"{len(events) - marks} of 30", flush=True)
        if time.perf_counter() - t0 >= args.seconds:
            return 0
        t = time.perf_counter()
        while time.perf_counter() - t < args.every:
            for _ in range(50):
                a @ a
            torch.cuda.synchronize()


if __name__ == "__main__":
    raise SystemExit(main())
