"""The fma_f32 kernel of ``csrc/dpa_matmul.cu`` beside the port's first
fma_f32 loop (``fma_f32_first.cu``: one shared buffer of 8-deep slices),
each at a 64x64 and a 128x128 tile, at 512^3 and 4096^3 on one card.

It separates what the tile gives (64 blocks of 64x64 at 512^3 against 16
of 128x128) from what the loop gives: each design runs at both tiles on
the same inputs. Per (size, tile, design): max|err| against ``torch.mm``
in f32 (TF32 off), which must stay below 1e-4 of max|C| (a sanity
check, not the port's limit: ``chip_smoke.py`` holds the kernel to
that), CUDA-events ms per call over back-to-back calls
(median of 5 rounds), and device ms per call under ``torch.profiler``
(``common.device_ms``). The designs run in the order first, kernel,
kernel, first, and each reading is the mean of its two turns. Prints the
card's name and power limit, one line per reading, and a JSON line.

    PYTHONPATH=src python -m repro_torch.benchmarks.fma_f32_designs
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess

import torch

from repro_torch.benchmarks.common import device_ms
from repro_torch.kernels import build
from repro_torch.kernels.dpa_matmul import dpa_matmul as dk

HERE = pathlib.Path(__file__).resolve().parent
SIZES = (512, 4096)
TILES = (64, 128)


def _first():
    fn = ctypes.CDLL(str(build.build("fma_f32_first", HERE))).fma_f32_first
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(a, b, tile):
        (m, k), n = a.shape, b.shape[1]
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                tile // 16, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fma_f32_first launch failed: cudaError {rc}")
        return out
    return run


def _events_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / n)
    return statistics.median(rounds)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fma_f32_designs needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    first = _first()
    designs = {
        "kernel": lambda a, b, t: dk.launch(a, b, "fma_f32", "ffma", t, t),
        "first": first,
    }
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for size in SIZES:
        a = torch.randn(size, size, device="cuda", generator=g)
        b = torch.randn(size, size, device="cuda", generator=g)
        want = torch.mm(a, b)
        calls = 200 if size <= 512 else 20
        for tile in TILES:
            readings = {name: [] for name in designs}
            for name in ("first", "kernel", "kernel", "first"):
                fn = designs[name]
                err = (fn(a, b, tile) - want).abs().max().item()
                if not err <= 1e-4 * want.abs().max().item():
                    raise AssertionError(f"{name} {size}^3 tile {tile}: "
                                         f"max|err| {err}")
                readings[name].append((
                    err, _events_ms(lambda: fn(a, b, tile), calls),
                    device_ms(lambda: fn(a, b, tile))))
            for name, turns in readings.items():
                row = dict(size=size, tile=tile, design=name,
                           max_abs_err=max(t[0] for t in turns),
                           ms=sum(t[1] for t in turns) / len(turns),
                           device_ms=sum(t[2] for t in turns) / len(turns),
                           turns=[[t[1], t[2]] for t in turns])
                rows.append(row)
                print(f"{size}^3 tile {tile}x{tile} {name}: max|err| "
                      f"{row['max_abs_err']:.3e}, events {row['ms']:.4f} ms, "
                      f"device {row['device_ms']:.4f} ms (turns "
                      f"{row['turns']})", flush=True)
    print(json.dumps({"fma_f32_designs": rows}))


if __name__ == "__main__":
    main()
