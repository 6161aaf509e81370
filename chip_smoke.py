"""Chip smoke test for the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which must pass (any failure exits non-zero):

1. build    — compile every CUDA kernel source from the repository (flash
              attention, STREAM, dpa_matmul: one nvcc per source, all in
              parallel).
2. kernels  — hold each kernel against its plain PyTorch version on the card:
              flash attention (D 16/64/128, Hkv = H, 8 and 1, ragged S and
              T, S = 1, T below 64, causal with and without q_offset, a
              window with and without a prefix, 64-row tiles crossing a
              head boundary, bf16 and f32) on the route and tile its plan
              picks (counted by route) and on every route and tile that
              takes the inputs, and bf16 views that start off a 16-byte
              boundary (planned onto ffma); the
              six STREAM kernels in f32 and bf16 at the reference tests'
              shapes and every shape the benches give them (read at
              block_rows 8, 16 and 256) and on views off a 16-byte
              boundary; dpa_matmul in its three variants
              at the reference tests' shapes, 512^3, 4096^3 and shapes at
              the edges of its routes (ragged against the tile and the
              stage, M below 64, rows TMA cannot describe), on the
              route and tile its plan picks (dpa4 exactly), every tile of
              the wgmma and FFMA routes at those edges (dpa4's own: K a
              multiple of 16), a forced wgmma launch TMA cannot describe
              (it must raise), dpa4's int8 transpose alone (equal to
              b.t()), and lower-precision controls that its limit must
              reject; the int8 quantized linear against its plain
              composition.
3. bench    — the paper's measurement path: the port's bench_bandwidth,
              bench_peak and bench_launch_latency on the card, three times,
              plus the bandwidth bench's read/write rows. The launch
              counts are zeroed just before and read just after; every
              STREAM and dpa_matmul kernel must have run, every dpa4
              launch on the wgmma route with its transpose.
4. small    — the smoke model in f32 on the card agrees with the same
              weights on the host (plain versions), logits and tokens. Its
              prefill attention is the f32 path of the flash kernel: the
              ffma route's launches are zeroed before and read after.
5. serve    — granite-20b at its published width (bf16 weights made on the
              card from a seed) through ContinuousEngine: 8 requests, batch
              4, max_seq 512, 32 new tokens each, four sharing a 128-token
              prefix. The flash launch counts are zeroed just before and
              read just after: every prefill layer on the wgmma route,
              none on ffma.
6. profile  — where the time goes in one full-width decode step and one
              256-token prefill: host time, device-busy time, kernel count.
7. timing   — each kernel held against its plain version and timed beside
              it, a PyTorch library call computing the same function, and
              its bound on the card: flash at the serve phase's prefill
              shapes on both routes (CUDA events over back-to-back calls,
              and the device time of one call under the profiler for each
              route and tile and for sdpa with a mask and, at q_offset 0,
              with is_causal) and the ffma route at the f32 smoke model's
              prefill shape, STREAM at 128 MiB f32, dpa_matmul at 512^3
              and 4096^3, dpa4's transpose at 4096^2 on four inputs in
              turn, so that each call reads and writes past the L2 (with
              each kernel's device time under the profiler beside the
              library call's and the names of the kernels it launched, at
              512^3 that of every tile of the wgmma and FFMA routes, and
              for dpa4 the mma route's and the transpose's share).
8. cli      — `python -m repro_torch.launch.serve --arch granite-20b
              --smoke` on the card.

The line before the last is the kernels JSON, the one before it the card's
name and power limit; the last line is the device JSON.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, f32
# without them, HBM3 bandwidth
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12

SERVE = dict(batch=4, max_seq=512, max_new=32, n_shared=4, shared_len=128,
             tails=(20, 90), n_random=4, random_lens=(30, 200), seed=0)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def alloc_counts():
    """(segments the caching allocator has taken from the driver, its
    retries after a failed cudaMalloc) so far: a change across a timed
    loop means the loop paid a synchronising cudaMalloc or cache flush."""
    import torch
    stats = torch.cuda.memory_stats()
    return (stats.get("segment.all.allocated", 0),
            stats.get("num_alloc_retries", 0))


def cuda_timed(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# phases


def phase_build():
    from repro_torch.kernels import build
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
    log(f"[build] {len(sources)} kernel source(s) {sources} built in "
        f"{time.perf_counter() - t0:.1f} s: {[p.name for p in paths]}")
    from repro_torch.kernels.flash_attention import ops as fops
    import torch
    for route, tiles in fops.TILES.items():
        for bm in tiles:
            for dt in ((torch.bfloat16,) if route == "wgmma" else
                       (torch.bfloat16, torch.float32)):
                for d in (64, 128):
                    log(f"[build] flash {route} tile {bm} D{d} "
                        f"{str(dt)[6:]}: "
                        f"{fops.kernel_attributes(route, bm, d, dt)}")
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    for variant, routes in dk.ROUTES.items():
        for route in routes:
            for bm, bn in dk.TILES[route]:
                log(f"[build] dpa_matmul {variant} route {route} tile "
                    f"{bm}x{bn}: {dk.kernel_attributes(variant, route, bm, bn)}")
    return sources


FLASH_CASES = [
    # (B, H, Hkv, S, T, D, causal, window, q_offset)
    (1, 8, 8, 48, 48, 16, True, None, 0),
    (2, 8, 1, 37, 53, 16, True, None, 16),
    (1, 8, 8, 70, 70, 16, False, None, 0),
    (1, 4, 4, 100, 100, 16, True, 24, 0),
    (1, 48, 1, 200, 512, 128, True, None, 128),
    (1, 48, 1, 23, 40, 128, True, None, 17),
    (1, 48, 48, 64, 64, 128, True, None, 0),
    (1, 48, 1, 96, 96, 128, True, 32, 0),
    (1, 48, 1, 33, 77, 128, False, None, 0),
    # the serve phase's prefills at full width: bucket S, T = max_seq, cold
    # (q_offset 0) and after the 128-token prefix hit
    (1, 48, 1, 64, 512, 128, True, None, 0),
    (1, 48, 1, 256, 512, 128, True, None, 0),
    (1, 48, 1, 128, 512, 128, True, None, 128),
    # the wgmma route's edges: 64-row tiles across a head boundary (S 200
    # cold; S 100, S 130), S = 1, T below and not a multiple of the 64-key
    # tile, a window after a prefix, Hkv 8 (g = 6), D 64
    (1, 48, 1, 200, 200, 128, True, None, 0),
    (1, 48, 1, 1, 300, 128, True, None, 299),
    (1, 8, 2, 20, 40, 64, True, None, 20),
    (1, 48, 1, 100, 130, 128, True, None, 30),
    (1, 48, 1, 96, 512, 128, True, 80, 200),
    (1, 48, 8, 130, 300, 128, True, None, 100),
    (2, 48, 8, 77, 77, 64, True, None, 0),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def flash_routes(dt, d):
    """Every (route, tile) of the flash kernel that takes these inputs."""
    from repro_torch.kernels.flash_attention import ops
    return [(r, bm) for r, tiles in ops.TILES.items() for bm in tiles
            if r == "ffma" or (dt == "bfloat16" and d in ops.WGMMA_HEAD_DIMS)]


def phase_kernels():
    """Each FLASH_CASES entry in f32 and bf16: the planned call (its route
    read from the launch counts) and every route and tile that takes the
    inputs, against ``ref.attention``. Returns the largest error of each
    route."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        tol = FLASH_TOL[dname]
        for (b, h, hkv, s, t, d, causal, win, off) in FLASH_CASES:
            q = torch.randn(b, h, s, d, device="cuda", generator=g).to(dt)
            k = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dt)
            v = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dt)
            want = ref.attention(q, k, v, causal=causal, window=win,
                                 q_offset=off).float()
            planned = ops.plan(b, h, hkv, s, t, d, dt, sms)
            before = dict(ops.route_launches)
            got = ops.flash_attention(q, k, v, causal=causal, window=win,
                                      q_offset=off)
            taken = {r: c - before[r] for r, c in ops.route_launches.items()
                     if c != before[r]}
            if taken != {planned[0]: 1}:
                raise AssertionError(f"flash planned {planned}, took "
                                     f"{taken}")
            by_tile = {}
            for route, bm in flash_routes(dname, d):
                out = got if (route, bm) == planned else ops.launch(
                    q, k, v, causal=causal, window=win, q_offset=off,
                    route=route, block_m=bm)
                torch.cuda.synchronize()
                by_tile[(route, bm)] = err = (
                    out.float() - want).abs().max().item()
                errs[route] = max(errs.get(route, 0.0), err)
                if not (err <= tol and out.dtype == dt):
                    raise AssertionError(
                        f"flash {route} tile {bm} disagrees at B{b} H{h} "
                        f"Hkv{hkv} S{s} T{t} D{d} {dname}: {err} > {tol}")
            log(f"[kernels] flash {dname} B{b} H{h} Hkv{hkv} S{s} T{t} D{d} "
                f"causal={causal} window={win} q_offset={off} (plan "
                f"{planned[0]} tile {planned[1]}): max|err| by route and "
                f"tile " + ", ".join(f"{r}/{bm} {e:.3e}" for (r, bm), e in
                                     by_tile.items()) + f" (tol {tol:g})")
    # bf16 at the serve's largest prefill, one of q, k, v a contiguous view
    # that starts one element past a 16-byte boundary: TMA cannot read it,
    # so the plan sends it to ffma
    tol = FLASH_TOL["bfloat16"]
    for which in range(3):
        x = []
        for i, shape in enumerate(((1, 48, 256, 128), (1, 1, 512, 128),
                                   (1, 1, 512, 128))):
            shift = int(i == which)
            x.append(torch.randn(shift + math.prod(shape), device="cuda",
                                 generator=g).to(torch.bfloat16)[shift:]
                     .view(shape))
        before = dict(ops.route_launches)
        got = ops.flash_attention(*x)
        taken = {r: c - before[r] for r, c in ops.route_launches.items()
                 if c != before[r]}
        err = (got.float() - ref.attention(*x).float()).abs().max().item()
        errs["ffma"] = max(errs["ffma"], err)
        log(f"[kernels] flash bf16 with {'qkv'[which]} off a 16-byte "
            f"boundary: took {taken}, max|err| {err:.3e} (tol {tol:g})")
        if taken != {"ffma": 1} or not err <= tol:
            raise AssertionError("an unaligned bf16 view was not planned "
                                 "onto ffma, or disagrees")
    return errs


# the reference tests' shapes, the bandwidth bench's 64 KB, 1 MB, 16 MB
# and 128 MB, and the launch-latency bench's 8x8 copy
STREAM_SHAPES = [(64, 128), (256, 128), (128, 512), (16, 1024), (256, 1024),
                 (4096, 1024), (32768, 1024), (8, 8)]
STREAM_X = 1.7
# STREAM read sums in another order: held to ref.read_limit per row block
# (1e-5 of sum(|a|), plus one bf16 ulp of the sum where the output is bf16)
READ_BLOCK_ROWS = (8, 16, 256)
# (M, K, N): the reference tests' shapes, the bench's 512^3, 4096^3, then
# the routes' edges: ragged against the wgmma tile and its 64-deep stage,
# M below 64, A or B rows of 200 bytes, which TMA cannot describe, and K
# and N odd (fma_f32's rows not 16-byte aligned: its 4-byte copies)
DPA_SHAPES = [(128, 256, 128), (256, 512, 128), (64, 128, 64),
              (512, 512, 512), (4096, 4096, 4096), (96, 200, 640),
              (8, 128, 64), (64, 100, 64), (64, 64, 100), (72, 99, 117)]
# every tile of the wgmma and FFMA routes is held at these: one 64^3
# tile, the edges above, a shape ragged every way, and 4096^3
DPA_TILE_SHAPES = [(64, 64, 64), (96, 200, 640), (8, 128, 64),
                   (300, 1000, 520), (4096, 4096, 4096)]
# dpa4 on wgmma takes K % 16 == 0 and any M and N: one 64^3 tile, M and N
# ragged against both tiles (K 16 x 63), M below 64 (K 16 x 13), K 16 x 7
# with M and N odd (the transpose's byte loads, the epilogue's single
# stores), and 4096^3
DPA4_TILE_SHAPES = [(64, 64, 64), (300, 1008, 520), (8, 208, 72),
                    (72, 112, 117), (4096, 4096, 4096)]
DPA_NEW_ROUTES = (("dpa2", "wgmma"), ("fma_f32", "ffma"), ("dpa4", "wgmma"))
# (K, N) of dpa4's transpose alone: ragged against its 128 x 128 tile, N
# not a multiple of 16, and 4096^2; the last also from an offset view
TRANSPOSE_SHAPES = [(16, 1), (112, 117), (208, 72), (1008, 520),
                    (4096, 4096)]
DPA_IN = {"fma_f32": "float32", "dpa2": "bfloat16", "dpa4": "int8"}
# the line of each STREAM function that reaches pl.pallas_call
STREAM_REPLACES = {"stream_copy": 53, "stream_scale": 61, "stream_add": 72,
                   "stream_triad": 80, "stream_write": 91, "stream_read": 103}
DPA_NAMES = tuple(f"dpa_matmul/{v}" for v in DPA_IN)
TRANSPOSE_NAME = "dpa_matmul/dpa4_transpose"


def _max_err(got, want) -> float:
    return (got.double() - want.double()).abs().max().item()


def stream_held(a, b, errs):
    """Each STREAM kernel against its plain version on (a, b); copy,
    scale, add, triad and write must be equal (the kernel rounds after each
    operation as eager PyTorch does), read within ``ref.read_limit`` per
    row block at each of READ_BLOCK_ROWS."""
    import torch
    from repro_torch.kernels.stream import ref, stream as sk
    x, shape, dt = STREAM_X, tuple(a.shape), a.dtype
    pairs = {
        "stream_copy": (sk.stream_copy(a), ref.copy(a)),
        "stream_scale": (sk.stream_scale(a, x), ref.scale(a, x)),
        "stream_add": (sk.stream_add(a, b), ref.add(a, b)),
        "stream_triad": (sk.stream_triad(a, b, x), ref.triad(a, b, x)),
        "stream_write": (sk.stream_write(shape, x, dt),
                         ref.write(shape, x, dt, "cuda")),
    }
    dname = str(dt).replace("torch.", "")
    read_err = 0.0
    for name, (got, want) in pairs.items():
        err = _max_err(got, want)
        errs[name] = max(errs.get(name, 0.0), err)
        if not (got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got, want)):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape} {dname}: max|err| {err}")
    for br in READ_BLOCK_ROWS:
        got, want = sk.stream_read(a, block_rows=br), ref.read(a, br)
        err = _max_err(got, want)
        read_err = max(read_err, err)
        errs["stream_read"] = max(errs.get("stream_read", 0.0), err)
        ok = bool(((got.float() - want.float()).abs()
                   <= ref.read_limit(a, want, br)).all().item())
        if not (ok and got.shape == want.shape and got.dtype == want.dtype):
            raise AssertionError(f"stream_read disagrees at {shape} {dname} "
                                 f"block_rows {br}: max|err| {err}")
    log(f"[kernels] stream {dname} {shape}: copy/scale/add/triad/write "
        f"equal to plain; read max|err| {read_err:.3e} (within "
        f"ref.read_limit at block_rows {READ_BLOCK_ROWS})")


def dpa_inputs(m, k, n, variant, g):
    import torch
    if variant == "dpa4":
        return (torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                              dtype=torch.int8))
    dt = getattr(torch, DPA_IN[variant])
    return (torch.randn(m, k, device="cuda", generator=g).to(dt),
            torch.randn(k, n, device="cuda", generator=g).to(dt))


def dpa_limit(a, b, want):
    """The largest |got - want| allowed for fma_f32 and dpa2: the reference
    test's atol 4e-5 + rtol (1e-5*sqrt(k) + 1e-6) times max(|want|,
    (|a| @ |b|) / sqrt(k)). Only the f32 summation order differs; the
    second term of the max is the typical size of a sum of k terms of
    random sign, which |want| falls below where the sum cancels (at
    k = 4096 that is where the reference's own rule is too tight)."""
    import torch
    k = a.shape[1]
    scale = torch.maximum(want.abs(),
                          (a.float().abs() @ b.float().abs()) / k ** 0.5)
    return 4e-5 + (1e-5 * k ** 0.5 + 1e-6) * scale


def dpa_held(a, b, variant, errs, tile=None):
    """The kernel against its plain version: dpa4 equal; fma_f32 and dpa2
    within ``dpa_limit``. ``tile`` (route, bm, bn) launches that plan in
    place of the one ``dpa_matmul`` picks."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk, ref
    got = (dk.launch(a, b, variant, *tile) if tile else
           dk.dpa_matmul(a, b, variant=variant))
    want = ref.matmul(a, b, variant)
    err = _max_err(got, want)
    name = f"dpa_matmul/{variant}"
    errs[name] = max(errs.get(name, 0.0), err)
    if variant == "dpa4":
        ok = got.dtype == torch.int32 and torch.equal(got, want)
    else:
        ok = got.dtype == torch.float32 and bool(
            ((got - want).abs() <= dpa_limit(a, b, want)).all().item())
    if not ok:
        raise AssertionError(f"{name} disagrees at {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}: max|err| {err}")
    return err


def dpa_controls(g):
    """``dpa_limit`` must reject a result of lower precision than the
    kernel's: fma_f32 against torch.mm with TF32 on (10-bit mantissa
    inputs), dpa2 against its own output rounded to bf16. Each control must
    exceed the limit somewhere, or the limit is too loose to catch it."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk, ref
    for size in (512, 4096):
        for variant in ("fma_f32", "dpa2"):
            a, b = dpa_inputs(size, size, size, variant, g)
            want = ref.matmul(a, b, variant)
            got = dk.dpa_matmul(a, b, variant=variant)
            if variant == "fma_f32":
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    low = torch.mm(a, b)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                what = "torch.mm with TF32"
            else:
                low = got.bfloat16().float()
                what = "the kernel's output rounded to bf16"
            limit = dpa_limit(a, b, want)
            over = ((low - want).abs() > limit).float().mean().item()
            log(f"[kernels] dpa_matmul {variant} {size}^3 control ({what}): "
                f"max|err| {_max_err(low, want):.3e}, {over:.1%} of entries "
                f"over the limit; the kernel: max|err| "
                f"{_max_err(got, want):.3e}; limit {limit.min().item():.3e}"
                f"-{limit.max().item():.3e}")
            if not over > 0:
                raise AssertionError(f"dpa_limit lets {what} through at "
                                     f"{size}^3")


def transpose_held(g, errs):
    """dpa4's int8 transpose alone against ``b.t().contiguous()``, bitwise,
    at TRANSPOSE_SHAPES and on a view of the last one off a 16-byte
    boundary (its byte loads)."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    cases = [(k, n, 0) for k, n in TRANSPOSE_SHAPES]
    cases.append(TRANSPOSE_SHAPES[-1] + (1,))
    for k, n, shift in cases:
        b = torch.randint(-128, 128, (shift + k * n,), device="cuda",
                          generator=g, dtype=torch.int8)[shift:].view(k, n)
        got, want = dk.transpose_int8(b), b.t().contiguous()
        if not torch.equal(got, want):
            raise AssertionError(f"the int8 transpose disagrees at K {k} "
                                 f"N {n} (offset {shift})")
    errs[TRANSPOSE_NAME] = 0.0
    log(f"[kernels] dpa4 transpose (K, N, offset) {cases}: equal to "
        f"b.t().contiguous()")


def phase_kernels_measurement():
    """STREAM, dpa_matmul and the quantized linear against their plain
    versions; returns the largest error of each kernel."""
    import torch
    from repro_torch.kernels.dpa_matmul import (dpa_matmul as dk, ops as
                                                dpa_ops, ref as dpa_ref)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    errs = {}
    for dname in ("float32", "bfloat16"):
        for shape in STREAM_SHAPES:
            a = torch.randn(shape, device="cuda", generator=g).to(
                getattr(torch, dname))
            b = torch.randn(shape, device="cuda", generator=g).to(a.dtype)
            stream_held(a, b, errs)
        # contiguous views one element past a 16-byte boundary: the
        # kernels' single-element path
        for which in range(2):
            a, b = (torch.randn(int(i == which) + 64 * 1000, device="cuda",
                                generator=g).to(getattr(torch, dname))
                    [int(i == which):].view(64, 1000) for i in range(2))
            log(f"[kernels] stream {dname}: {'ab'[which]} off a 16-byte "
                f"boundary")
            stream_held(a, b, errs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for variant in DPA_IN:
        for m, k, n in DPA_SHAPES:
            a, b = dpa_inputs(m, k, n, variant, g)
            err = dpa_held(a, b, variant, errs)
            route, bm, bn = dk.plan(m, n, k, variant, sms)
            log(f"[kernels] dpa_matmul {variant} {m}x{k}x{n} (route {route}, "
                f"tile {bm}x{bn}, {-(-m // bm) * -(-n // bn)} blocks): "
                f"max|err| {err:.3e}" + (
                    " (exact required)" if variant == "dpa4" else
                    f" (atol 4e-5, rtol {1e-5 * k ** 0.5 + 1e-6:.2e} of "
                    f"max(|want|, |a|@|b|/sqrt(k)))"))
    for variant, route in DPA_NEW_ROUTES:
        # odd K and N only where the route takes rows of any alignment
        shapes = (DPA4_TILE_SHAPES if variant == "dpa4" else
                  DPA_TILE_SHAPES + ([(72, 99, 117)] if route == "ffma"
                                     else []))
        for bm, bn in dk.TILES[route]:
            worst = max(dpa_held(*dpa_inputs(m, k, n, variant, g), variant,
                                 errs, tile=(route, bm, bn))
                        for m, k, n in shapes)
            log(f"[kernels] dpa_matmul {variant} route {route} tile "
                f"{bm}x{bn} at {shapes}: max|err| {worst:.3e} "
                + ("(exact required)" if variant == "dpa4" else
                   "(within dpa_limit)"))
    for variant, (m, k, n) in (("dpa2", (64, 100, 64)),
                               ("dpa2", (64, 64, 100)),
                               ("dpa4", (64, 200, 64))):
        a, b = dpa_inputs(m, k, n, variant, g)
        try:
            dk.launch(a, b, variant, "wgmma", 64, 64)
        except RuntimeError as e:
            log(f"[kernels] dpa_matmul {variant} wgmma refuses "
                f"{m}x{k}x{n}: {e}")
        else:
            raise AssertionError(f"the {variant} wgmma route took "
                                 f"{m}x{k}x{n}, whose rows TMA cannot "
                                 f"describe")
    transpose_held(g, errs)
    dpa_controls(g)
    for m, k, n in ((64, 128, 64), (512, 4096, 4096)):
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) / k ** 0.5
        before = dict(dk.route_launches)
        got = dpa_ops.quantized_linear(x, w)
        taken = {r: c - before[r] for r, c in dk.route_launches.items()
                 if c != before[r]}
        xq, xs = dpa_ops.quantize_int8(x, axis=1)
        wq, ws = dpa_ops.quantize_int8(w, axis=0)
        want = dpa_ref.matmul(xq, wq, "dpa4").float() * xs * ws
        ok = torch.equal(got, want) and taken == {"dpa4/wgmma": 1}
        log(f"[kernels] quantized_linear {m}x{k}x{n} (route {taken}): "
            f"equal to its plain composition {torch.equal(got, want)}")
        if not ok:
            raise AssertionError("quantized_linear disagrees with its plain "
                                 "composition or left the wgmma route")
    torch.cuda.synchronize()
    return errs


BENCH_REPEATS = 3


def phase_bench():
    """The paper's measurement path on the card: the port's three benches
    (each BENCH_REPEATS times), then the bandwidth bench's read and write
    rows (its docstring names them; the reference's code emits
    copy/scale/add/triad only). Launch counts: zeroed before, read after."""
    import functools
    import torch
    from repro_torch.benchmarks import (bench_bandwidth, bench_launch_latency,
                                        bench_peak)
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    from repro_torch.kernels.stream import stream as sk
    readings = {}
    for name in sk.launches:
        sk.launches[name] = 0                 # the bench path starts here
    for name in dk.launches:
        dk.launches[name] = 0
    for name in dk.route_launches:
        dk.route_launches[name] = 0
    dk.transposes["launches"] = 0
    t0 = time.perf_counter()
    for rep in range(BENCH_REPEATS):
        for bench in (bench_bandwidth.run, bench_peak.run,
                      bench_launch_latency.run,
                      functools.partial(bench_bandwidth.run,
                                        ops=("read", "write"))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rows = bench()
            for line in buf.getvalue().splitlines():
                log(f"[bench] run {rep}: {line}")
            for name, row in rows.rows.items():
                readings.setdefault(name, []).append(row)
    torch.cuda.synchronize()
    launches = {name: sk.launches[name] for name in STREAM_REPLACES}
    launches.update({f"dpa_matmul/{v}": dk.launches[v] for v in DPA_IN})
    routes = dict(dk.route_launches)
    launches[TRANSPOSE_NAME] = dk.transposes["launches"]
    # ... and ends here
    log(f"[bench] {BENCH_REPEATS} runs in {time.perf_counter() - t0:.1f} s; "
        f"launches on the bench path: {launches}; dpa_matmul by route: "
        f"{routes}")
    for name, rows in readings.items():
        us = sorted(r["us_per_call"] for r in rows)
        log(f"[bench] spread {name}: us_per_call min {us[0]:.1f} median "
            f"{us[len(us) // 2]:.1f} max {us[-1]:.1f} over {len(us)} runs; "
            f"derived {[r['derived'] for r in rows]}")
    missing = [n for n, c in {**launches, "dpa_matmul/dpa2/wgmma":
                              routes["dpa2/wgmma"]}.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the bench path: "
                             f"{missing}")
    # every dpa4 launch on wgmma, each with its transpose
    if not (routes["dpa4/mma"] == 0
            and routes["dpa4/wgmma"] == launches["dpa_matmul/dpa4"]
            == launches[TRANSPOSE_NAME]):
        raise AssertionError(f"dpa4 on the bench path: routes {routes}, "
                             f"transposes {launches[TRANSPOSE_NAME]}")
    return launches


def phase_small():
    """Smoke model, f32: the card (flash kernel) against the host (plain
    versions) on the same weights and tokens."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("granite-20b").replace(dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(1), "cpu")
    gpu = _to_cuda(cpu)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 37))
    out = {}
    for route in flash_ops.route_launches:
        flash_ops.route_launches[route] = 0        # the f32 path starts here
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        caches = model.init_cache(1, 64, torch.float32, device=dev)
        t = torch.as_tensor(toks, device=dev)
        logits, caches = model.prefill(params, {"tokens": t[:, :29]}, caches)
        logits2, caches = model.prefill(params, {"tokens": t[:, 29:]}, caches,
                                        start_pos=29)
        out[name] = (logits.cpu(), logits2.cpu())
    err = max((a - b).abs().max().item()
              for a, b in zip(out["cpu"], out["cuda"]))
    same_tok = all(torch.equal(a.argmax(-1), b.argmax(-1))
                   for a, b in zip(out["cpu"], out["cuda"]))
    finite = all(torch.isfinite(x).all().item() for x in out["cuda"])
    routes = dict(flash_ops.route_launches)        # ... and ends here
    log(f"[small] smoke f32 card vs host: max|logit err| {err:.3e} "
        f"(tol 1e-4), same argmax {same_tok}, finite {finite}; flash "
        f"launches by route {routes}")
    if not (err <= 1e-4 and same_tok and finite):
        raise AssertionError("card and host disagree on the smoke model")
    # two prefills of each layer, all f32: the ffma route only
    if routes != {"ffma": 2 * cfg.num_layers, "wgmma": 0}:
        raise AssertionError(f"the f32 path took flash routes {routes}")
    # the first prefill's flash shape: q [1,H,29,D], kv [1,Hkv,64,D]
    return routes["ffma"], (cfg.num_heads, cfg.num_kv_heads, 29, 64,
                            cfg.head_dim)


def serve_requests(vocab):
    import numpy as np
    from repro_torch.serve.engine import Request
    c = SERVE
    rng = np.random.default_rng(c["seed"])
    shared = rng.integers(0, vocab, c["shared_len"]).astype(np.int32)
    reqs = []
    for i in range(c["n_shared"]):
        tail = rng.integers(0, vocab, int(rng.integers(*c["tails"]))
                            ).astype(np.int32)
        reqs.append(np.concatenate([shared, tail]))
    for _ in range(c["n_random"]):
        reqs.append(rng.integers(0, vocab, int(rng.integers(
            *c["random_lens"]))).astype(np.int32))
    return [Request(i, p, max_new_tokens=c["max_new"])
            for i, p in enumerate(reqs)]


def phase_serve(card):
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.step import bucket_for
    cfg = configs.get("granite-20b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SERVE["seed"])
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} q heads / {cfg.num_kv_heads} kv, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params / 1e9:.2f} B "
        f"params in {cfg.dtype} made on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    # warm-up pass over the same prompts, 2 tokens each: the first call of
    # each shape pays one-time costs (cuBLAS heuristics, module loading)
    # that the measured pass below must not carry
    t0 = time.perf_counter()
    warm = serve_requests(cfg.vocab_size)
    for r in warm:
        r.max_new_tokens = 2
    ContinuousEngine(model, params, batch_size=SERVE["batch"],
                     max_seq=SERVE["max_seq"], telemetry=False).serve(warm)
    torch.cuda.synchronize()
    log(f"[serve] warm-up pass ({len(warm)} requests x 2 tokens) in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ContinuousEngine(model, params, batch_size=SERVE["batch"],
                           max_seq=SERVE["max_seq"])
    reqs = serve_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    flash_ops.launches = 0                       # the main path starts here
    for route in flash_ops.route_launches:
        flash_ops.route_launches[route] = 0
    t0 = time.perf_counter()
    # count the host syncs: the designed ones are one per prefill (the
    # first token) and one per decode step (the [B, 1] token fetch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            stats = eng.serve(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_ops.launches}   # ... and ends here
    routes = dict(flash_ops.route_launches)
    launches["flash_attention/wgmma"] = routes["wgmma"]
    n_syncs = sum("synchronizing CUDA operation" in str(w.message)
                  for w in caught)
    n_tok = stats["tokens_decoded"]
    energy = stats["energy_j"]
    log(f"[serve] flash launches by route: {routes}")
    log(f"[serve] {stats['completed']} completed, {stats['shed']} shed, "
        f"{stats['prefills']} prefills, {stats['decode_steps']} decode steps, "
        f"prefill_compiles {stats['prefill_compiles']}, decode_compiles "
        f"{stats['decode_compiles']}, prefix cache {stats['prefix_cache']}")
    log(f"[serve] wall {wall:.3f} s; {n_tok / wall:.2f} tok/s over the "
        f"wall (all tokens over all time); prefill {stats['prefill_s']:.3f} "
        f"s; decode {stats['decode_s']:.3f} s at "
        f"{stats['decode_tok_per_s']:.2f} tok/s (decode only); {n_tok} "
        f"tokens; "
        f"modeled energy {energy:.2f} J = {energy / n_tok:.4f} J/token "
        f"(H100_SXM power model over measured windows); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {card}")
    for r in reqs:
        log(f"[serve]   req {r.req_id}: prompt {len(r.prompt)} "
            f"(cached {r.cached_prompt_tokens}) -> {len(r.output)} tokens "
            f"[{r.finish_reason}] {r.energy_j:.3f} J")
    # checks: the run, the kernels it went through, the joule partition
    slot_tags = {eng.tel.slot_tag(i) for i in range(eng.batch_size)}
    slot_j = 0.0
    for blk in eng.tel.session.blocks():
        m = np.zeros(blk.n, bool)
        for tag in slot_tags:
            m |= blk.tag_mask(tag)
        slot_j += float((blk.watts * blk.dt)[m].sum())
    parts = sum(r.energy_j for r in reqs)
    checks = {
        "all 8 complete": stats["completed"] == len(reqs) == 8,
        "every request at its budget": all(
            len(r.output) == SERVE["max_new"] for r in reqs),
        "decode_compiles == 1": stats["decode_compiles"] == 1,
        "host syncs == prefills + decode steps": (
            n_syncs == stats["prefills"] + stats["decode_steps"]),
        "prefix hit rate > 0": stats["prefix_cache"]["hit_rate"] > 0,
        "flash launches == layers x prefills": (
            launches["flash_attention"]
            == cfg.num_layers * stats["prefills"] > 0),
        "flash wgmma launches == layers x prefills, ffma 0": (
            routes == {"wgmma": cfg.num_layers * stats["prefills"],
                       "ffma": 0}),
        "every request has energy > 0": all(r.energy_j > 0 for r in reqs),
        "joule partition (1e-6 J)": abs(parts - slot_j) <= 1e-6,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.output),
    }
    for name, ok in checks.items():
        log(f"[serve] check {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: "
                             f"{[n for n, ok in checks.items() if not ok]}")
    # the prefill shapes the path gave the kernel: (S bucket, q_offset)
    shapes = sorted({(bucket_for(len(r.prompt) - r.cached_prompt_tokens,
                                 eng.buckets), r.cached_prompt_tokens)
                     for r in reqs})
    return cfg, eng, launches, shapes


def _profiled(fn, n=3):
    """(host ms per call, device-busy ms per call, kernels per call,
    {kernel name: device ms per call}) of ``fn`` on the card: host time
    without the profiler, device time as the sum of the CUDA kernels'
    durations under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    return host_ms, sum(by_name.values()), count / n, by_name


def _device_ms(fn, n=10, sessions=3, by_kernel=False):
    """``repro_torch.benchmarks.common.device_ms``: one call's device time
    under ``torch.profiler``, median over three sessions."""
    from repro_torch.benchmarks.common import device_ms
    return device_ms(fn, n, sessions, by_kernel)


def _names(by_kernel) -> str:
    """The kernels of a ``_device_ms(..., by_kernel=True)`` reading, each
    with its device ms, names cut to 72 characters."""
    return "; ".join(f"{k[:72]} {v:.4f} ms" for k, v in by_kernel.items())


def phase_profile(eng):
    """Where the time goes in the serve phase's two steps at full width:
    one decode step of the whole batch and one cold 256-token prefill (the
    serve's largest bucket)."""
    import torch
    ad = eng.adapter
    b = eng.batch_size
    tokens = torch.zeros((b, 1), dtype=torch.int32, device=ad.device)
    pos = torch.full((b,), 200, dtype=torch.int32, device=ad.device)
    prompt = torch.zeros((1, 256), dtype=torch.int32, device=ad.device)
    null_row = torch.zeros(ad.n_slot_blocks, dtype=torch.int32,
                           device=ad.device)
    # every slot is free after the serve: tables point at the null block,
    # so these steps write only there
    steps = {
        "decode step (4 rows)": lambda: ad.decode_step(tokens, pos),
        "prefill (256 tokens)": lambda: ad._prefill_slot(
            ad.params, prompt, 200, 0, null_row, ad.caches),
    }
    out = {}
    for name, fn in steps.items():
        host, dev, n_k, by_name = _profiled(fn)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        flash = sum(v for k, v in by_name.items() if "flash_fwd" in k)
        idle = 1.0 - dev / host if host > 0 else 0.0
        log(f"[profile] {name}: host {host:.3f} ms, device busy "
            f"{dev:.3f} ms (idle share {idle:.1%}), {n_k:.0f} kernels; "
            f"flash kernel {flash:.3f} ms; top: "
            + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
        out[name] = dict(host_ms=host, device_ms=dev, kernels=n_k,
                         flash_ms=flash)
    return out


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.cuda()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def flash_work(s, t, d, h, hkv, q_offset, itemsize):
    """(bytes, operations) the causal function needs at these shapes: q read
    and the output written once, k and v read once up to the last key a
    query can see (``q_offset + s``); 4·D operations for every (query,
    visible key) pair."""
    pairs = sum(min(q_offset + i + 1, t) for i in range(s))
    n_bytes = itemsize * (2 * h * s * d + 2 * hkv * min(t, q_offset + s) * d)
    return n_bytes, 4 * d * h * pairs


def phase_timing(cfg, shapes):
    """Flash at each of the serve phase's prefill shapes, bf16: the planned
    call (wgmma) and the ffma route beside the plain version and sdpa with
    the causal mask as a tensor (the same function at any q_offset), by
    CUDA events over back-to-back calls; and the device time of one call
    under the profiler of each route and tile, of sdpa with the mask and,
    at q_offset 0, of sdpa with is_causal (the call PyTorch's own flash
    backend takes). Held at the stated tolerances on the same inputs.
    Returns {route: [row per shape]}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    h, hkv, d, t = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    SERVE["max_seq"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {"wgmma": [], "ffma": []}
    for s, off in shapes:
        g = torch.Generator(device="cuda")
        g.manual_seed(s + off)
        q, k, v = (torch.randn(1, n, m, d, device="cuda", generator=g,
                               dtype=torch.bfloat16)
                   for n, m in ((h, s), (hkv, t), (hkv, t)))
        mask = (torch.arange(t, device="cuda")[None, :]
                <= torch.arange(s, device="cuda")[:, None] + off)
        planned = ops.plan(1, h, hkv, s, t, d, torch.bfloat16, sms)
        if planned[0] != "wgmma":
            raise AssertionError(f"the serve's bf16 prefill planned "
                                 f"{planned}")
        calls = {
            "wgmma": lambda: ops.flash_attention(q, k, v, q_offset=off),
            "ffma": lambda: ops.launch(q, k, v, causal=True, window=None,
                                       q_offset=off, route="ffma",
                                       block_m=64),
        }
        before = dict(ops.route_launches)
        events = {r: cuda_timed(fn) for r, fn in calls.items()}
        taken = {r: c - before[r] for r, c in ops.route_launches.items()}
        if taken != {"wgmma": 23, "ffma": 23}:
            raise AssertionError(f"timed calls took routes {taken}")
        device = {f"wgmma/{bm}": _device_ms(lambda: ops.launch(
            q, k, v, causal=True, window=None, q_offset=off, route="wgmma",
            block_m=bm)) for bm in ops.TILES["wgmma"]}
        device["ffma/64"] = _device_ms(calls["ffma"])
        plain_ms = cuda_timed(lambda: ref.attention(q, k, v, q_offset=off),
                              iters=5)
        sdpa = lambda: F.scaled_dot_product_attention(      # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
        lib = {"mask": (cuda_timed(sdpa), _device_ms(sdpa))}
        if off == 0:
            causal = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
            lib["is_causal"] = (cuda_timed(causal), _device_ms(causal))
        # held at the stated tolerances on these very inputs: bf16 on both
        # routes, f32 (the ffma route's own dtype) on the planned call
        errs = {}
        for route in calls:
            errs[route] = (calls[route]().float() - ref.attention(
                q, k, v, q_offset=off).float()).abs().max().item()
        qf, kf, vf = (x.float() for x in (q, k, v))
        errs["float32"] = (ops.flash_attention(qf, kf, vf, q_offset=off)
                           - ref.attention(qf, kf, vf, q_offset=off)
                           ).abs().max().item()
        for name, err in errs.items():
            tol = FLASH_TOL["float32" if name == "float32" else "bfloat16"]
            if not err <= tol:
                raise AssertionError(f"flash {name} disagrees at S {s} "
                                     f"q_offset {off}: {err} > {tol}")
        n_bytes, n_ops = flash_work(s, t, d, h, hkv, off, 2)
        t_bytes = n_bytes / PEAK_BYTES * 1e3
        t_ops = n_ops / PEAK_OPS["bfloat16"] * 1e3
        for route, bm in (planned, ("ffma", 64)):
            rows[route].append(dict(
                s=s, q_offset=off, t=t, ms=events[route],
                device_ms=device[f"{route}/{bm}"], plain_ms=plain_ms,
                library_ms=lib["mask"][0],
                library_device_ms=lib["mask"][1],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                max_abs_err=max(errs[route], errs["float32"])
                if route == "ffma" else errs[route]))
        log(f"[timing] flash bf16 q[1,{h},{s},{d}] kv[1,{hkv},{t},{d}] "
            f"q_offset {off} (plan {planned[0]} tile {planned[1]}): events "
            f"wgmma {events['wgmma']:.4f} ms, ffma {events['ffma']:.4f} ms, "
            f"plain {plain_ms:.4f} ms, " + ", ".join(
                f"sdpa {n} {e:.4f} ms" for n, (e, _) in lib.items())
            + "; device time a call: " + ", ".join(
                f"{n} {v:.4f} ms" for n, v in device.items()) + ", "
            + ", ".join(f"sdpa {n} {dv:.4f} ms" for n, (_, dv) in
                        lib.items())
            + f"; bound {max(t_bytes, t_ops):.5f} ms "
            f"({'bytes' if t_bytes > t_ops else 'operations'}); max|err| "
            f"bf16 wgmma {errs['wgmma']:.3e}, ffma {errs['ffma']:.3e} (tol "
            f"{FLASH_TOL['bfloat16']:g}), f32 {errs['float32']:.3e} (tol "
            f"{FLASH_TOL['float32']:g})")
    return rows


def timing_flash_f32(shape):
    """The ffma route on its own path: f32 at the smoke model's first
    prefill shape (q [1,H,S,D], kv [1,Hkv,T,D], q_offset 0), planned and
    counted, by CUDA events and device time beside the plain version and
    sdpa with the mask; held at the f32 tolerance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    h, hkv, s, t, d = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(s)
    q, k, v = (torch.randn(1, n, m, d, device="cuda", generator=g)
               for n, m in ((h, s), (hkv, t), (hkv, t)))
    mask = (torch.arange(t, device="cuda")[None, :]
            <= torch.arange(s, device="cuda")[:, None])
    call = lambda: ops.flash_attention(q, k, v)             # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(          # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=True)
    before = dict(ops.route_launches)
    ms = cuda_timed(call)
    taken = {r: c - before[r] for r, c in ops.route_launches.items()
             if c != before[r]}
    if taken != {"ffma": 23}:
        raise AssertionError(f"the f32 calls took routes {taken}")
    err = (call() - ref.attention(q, k, v)).abs().max().item()
    if not err <= FLASH_TOL["float32"]:
        raise AssertionError(f"flash ffma f32 disagrees: {err}")
    n_bytes, n_ops = flash_work(s, t, d, h, hkv, 0, 4)
    row = dict(_row(ms, cuda_timed(lambda: ref.attention(q, k, v), iters=5),
                    cuda_timed(sdpa), n_bytes, n_ops, PEAK_OPS["float32"],
                    err),
               device_ms=_device_ms(call), library_device_ms=_device_ms(sdpa),
               timed_at=f"f32 q[1,{h},{s},{d}] kv[1,{hkv},{t},{d}] "
                        f"q_offset 0 (the f32 smoke model's prefill)")
    log(f"[timing] flash ffma {row['timed_at']}: events {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, sdpa mask {row['library_ms']:.4f} "
        f"ms; device {row['device_ms']:.4f} ms, sdpa mask "
        f"{row['library_device_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}); max|err| {err:.3e} (tol "
        f"{FLASH_TOL['float32']:g})")
    return row


def _row(ms, plain_ms, lib_ms, n_bytes, n_ops, peak_ops, err):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err)


def timing_stream(errs):
    """The six STREAM kernels at 128 MiB f32 (32768x1024), past the 50 MB
    L2, beside their plain versions and one library call each."""
    import torch
    from repro_torch.kernels.stream import ref, stream as sk
    shape = (32768, 1024)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    a = torch.randn(shape, device="cuda", generator=g)
    b = torch.randn(shape, device="cuda", generator=g)
    stream_held(a, b, errs)                   # held on these very inputs
    x = STREAM_X
    xr = ref.scalar(x, a.dtype).item()
    n = a.numel() * a.element_size()
    n_blocks = shape[0] // 256
    cases = {
        # name: (kernel, plain, library, bytes, operations)
        "stream_copy": (lambda: sk.stream_copy(a), lambda: ref.copy(a),
                        lambda: a.clone(), 2 * n, 0),
        "stream_scale": (lambda: sk.stream_scale(a, x),
                         lambda: ref.scale(a, x), lambda: torch.mul(a, xr),
                         2 * n, a.numel()),
        "stream_add": (lambda: sk.stream_add(a, b), lambda: ref.add(a, b),
                       lambda: torch.add(a, b), 3 * n, a.numel()),
        "stream_triad": (lambda: sk.stream_triad(a, b, x),
                         lambda: ref.triad(a, b, x),
                         lambda: torch.add(b, a, alpha=xr), 3 * n,
                         2 * a.numel()),
        "stream_write": (lambda: sk.stream_write(shape, x),
                         lambda: ref.write(shape, x, a.dtype, "cuda"),
                         lambda: torch.full(shape, xr, device="cuda"), n, 0),
        "stream_read": (lambda: sk.stream_read(a), lambda: ref.read(a),
                        lambda: a.view(n_blocks, -1).sum(1),
                        n + n_blocks * 4, a.numel()),
    }
    rows = {}
    for name, (kern, plain, lib, n_bytes, n_ops) in cases.items():
        before = alloc_counts()
        ms = cuda_timed(kern)
        allocs = [b - a for a, b in zip(before, alloc_counts())]
        plain_ms, lib_ms = cuda_timed(plain), cuda_timed(lib)
        rows[name] = r = _row(ms, plain_ms, lib_ms, n_bytes, n_ops,
                              PEAK_OPS["float32"], errs[name])
        r["device_ms"] = _device_ms(kern)
        r["library_device_ms"], lib_by = _device_ms(lib, by_kernel=True)
        log(f"[timing] {name} f32 {shape}: kernel {ms:.4f} ms "
            f"({n_bytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}, {n_bytes} bytes); kernel at "
            f"{r['bound_ms'] / ms:.1%} of the bound; device time a call: "
            f"kernel {r['device_ms']:.4f} ms "
            f"({r['bound_ms'] / r['device_ms']:.1%} of the bound), library "
            f"{r['library_device_ms']:.4f} ms ({_names(lib_by)}); "
            f"allocator in the kernel's events loop: {allocs[0]} new "
            f"segments, {allocs[1]} retries")
    return rows


def timing_dpa(errs):
    """dpa_matmul at 512^3 (the bench's size) and 4096^3 beside its plain
    version and one library call: torch.mm in f32 with TF32 off, torch.mm
    in bf16 (which writes bf16, not f32), torch._int_mm (int8 -> int32).
    Logged beside them, as yardsticks only: torch.mm in bf16 with
    out_dtype f32 where this torch takes it, and the device time of one
    kernel call and of one library call under the profiler (at 512^3 the
    events time of back-to-back calls is mostly the host's dispatch). The
    route each call took is read from the per-route launch counts."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk, ref
    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = {"fma_f32": torch.mm, "dpa2": torch.mm, "dpa4": torch._int_mm}
    peak = {v: PEAK_OPS[DPA_IN[v]] for v in DPA_IN}
    rows = {}
    for size in (512, 4096):
        for variant in DPA_IN:
            a, b = dpa_inputs(size, size, size, variant, g)
            dpa_held(a, b, variant, errs)
            iters = 20 if size == 512 else 10
            route, bm, bn = dk.plan(size, size, size, variant, sms)
            before = dict(dk.route_launches)
            allocs = alloc_counts()
            ms = cuda_timed(lambda: dk.dpa_matmul(a, b, variant=variant),
                            iters=iters)
            allocs = [y - x for x, y in zip(allocs, alloc_counts())]
            taken = {r: c - before[r] for r, c in dk.route_launches.items()
                     if c != before[r]}
            if set(taken) != {f"{variant}/{route}"}:
                raise AssertionError(f"{variant} {size}^3 planned route "
                                     f"{route}, took {taken}")
            plain_ms = cuda_timed(lambda: ref.matmul(a, b, variant),
                                  iters=iters)
            lib_ms = cuda_timed(lambda: lib[variant](a, b), iters=iters)
            dev_ms, dev_by = _device_ms(
                lambda: dk.dpa_matmul(a, b, variant=variant), by_kernel=True)
            dev_lib_ms, lib_by = _device_ms(lambda: lib[variant](a, b),
                                            by_kernel=True)
            extra = ""
            if variant == "dpa4":
                # the transpose's share of the call, and the mma route on
                # the same inputs: plan's route rule rests on this reading
                t_ms = sum(v for k, v in dev_by.items() if "transpose" in k)
                mma_ms = _device_ms(lambda: dk.launch(a, b, "dpa4", "mma",
                                                      128, 128))
                extra += (f", device time by kernel: {_names(dev_by)} "
                          f"(transpose {t_ms / dev_ms:.1%} of the call), "
                          f"mma route 128x128 {mma_ms:.4f} ms")
                if not dev_ms < mma_ms:
                    raise AssertionError(f"dpa4 {size}^3: wgmma {dev_ms} ms "
                                         f"is not below mma {mma_ms} ms")
            if size == 512 and len(dk.TILES[route]) > 1:
                # every tile of the route at the bench's size, the reading
                # plan's tile rule rests on
                tiles = {f"{tm}x{tn}": _device_ms(lambda: dk.launch(
                    a, b, variant, route, tm, tn))
                    for tm, tn in dk.TILES[route]}
                extra += (", device time a call by tile: " + ", ".join(
                    f"{t} {v:.4f} ms" for t, v in tiles.items()))
            if variant == "dpa2":
                try:
                    f32_ms = cuda_timed(lambda: torch.mm(
                        a, b, out_dtype=torch.float32), iters=iters)
                    extra += f", torch.mm out_dtype=f32 {f32_ms:.4f} ms"
                except (TypeError, RuntimeError) as e:
                    extra += (f", torch.mm out_dtype=f32 not taken "
                              f"({type(e).__name__})")
            n_ops = 2 * size ** 3
            n_bytes = 2 * size * size * a.element_size() + size * size * 4
            name = f"dpa_matmul/{variant}"
            r = _row(ms, plain_ms, lib_ms, n_bytes, n_ops, peak[variant],
                     errs[name])
            r.update(device_ms=dev_ms, library_device_ms=dev_lib_ms)
            if variant == "dpa4":
                r.update(transpose_device_ms=t_ms, mma_device_ms=mma_ms)
            rows[(name, size)] = r
            log(f"[timing] {name} {size}^3 (route {route}, tile {bm}x{bn}, "
                f"launches by route {taken}): kernel {ms:.4f} ms "
                f"({n_ops / ms / 1e9:.2f} Top/s), plain {plain_ms:.4f} ms, "
                f"library {lib_ms:.4f} ms{extra}, bound {r['bound_ms']:.5f} "
                f"ms ({r['bound_by']}); kernel at {r['bound_ms'] / ms:.1%} "
                f"of the bound; device time a call under the profiler: "
                f"kernel {dev_ms:.4f} ms, library {dev_lib_ms:.4f} ms "
                f"({_names(lib_by)}); allocator in the kernel's events "
                f"loop: {allocs[0]} new segments, {allocs[1]} retries")
    return rows


def timing_transpose(errs, in_call_ms):
    """dpa4's int8 transpose alone at 4096^2 (B of the 4096^3 product)
    beside its plain version, ``b.t().contiguous()``, which is also the one
    PyTorch call computing it; bound by bytes, K N read and K N written.
    Each timed call takes the next of four inputs and its output stays
    alive for four calls, so what a call reads and writes was last touched
    at least 96 MiB of traffic before, past the 50 MB L2 (back to back on
    one B, B and B^T stay there and the time reads below the HBM bound).
    ``in_call_ms`` is its device time inside the 4096^3 dpa4 call."""
    import collections
    import itertools
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    k = n = 4096
    bs = [torch.randint(-128, 128, (k, n), device="cuda", generator=g,
                        dtype=torch.int8) for _ in range(4)]
    for b in bs:
        if not torch.equal(dk.transpose_int8(b), b.t().contiguous()):
            raise AssertionError("the int8 transpose disagrees at 4096^2")

    def rotating(fn):
        inputs, outs = itertools.cycle(bs), collections.deque(maxlen=4)
        return lambda: outs.append(fn(next(inputs)))
    kern = rotating(dk.transpose_int8)
    plain = rotating(lambda b: b.t().contiguous())
    ms, plain_ms = cuda_timed(kern), cuda_timed(plain)
    r = _row(ms, plain_ms, plain_ms, 2 * k * n, 0, PEAK_OPS["int8"],
             errs[TRANSPOSE_NAME])
    r["device_ms"] = _device_ms(kern)
    r["device_ms_in_dpa4_call"] = in_call_ms
    r["library_device_ms"], lib_by = _device_ms(plain, by_kernel=True)
    log(f"[timing] {TRANSPOSE_NAME} int8 [{k},{n}] -> [{n},{k}], four "
        f"inputs in turn: kernel {ms:.4f} ms, plain = library "
        f"(b.t().contiguous()) {plain_ms:.4f} ms, bound "
        f"{r['bound_ms']:.5f} ms (bytes); device time a call: kernel "
        f"{r['device_ms']:.4f} ms ({r['bound_ms'] / r['device_ms']:.1%} of "
        f"the bound), inside the 4096^3 dpa4 call {in_call_ms:.4f} ms "
        f"({r['bound_ms'] / in_call_ms:.1%}), library "
        f"{r['library_device_ms']:.4f} ms ({_names(lib_by)})")
    return r


def phase_cli():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", "granite-20b", "--smoke"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.strip().splitlines():
        log(f"[cli] {line}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"CLI exited {proc.returncode}")
    log(f"[cli] ok in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails here, before any output, alone)
    t_start = time.perf_counter()
    card = smi_line()
    idle = subprocess.run(["nvidia-smi", "--query-gpu=power.draw,clocks.sm,"
                           "clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {card}; before any work "
        f"(power draw, SM clock, max SM clock): {idle}")
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    flash_errs = phase_kernels()
    errs = phase_kernels_measurement()
    bench_launches = phase_bench()
    f32_launches, f32_shape = phase_small()
    cfg, eng, launches, shapes = phase_serve(card)
    launches.update(bench_launches)
    phase_profile(eng)
    del eng                                    # frees the 56 GB of weights
    flash_rows = phase_timing(cfg, shapes)
    ffma_row = timing_flash_f32(f32_shape)
    stream_rows = timing_stream(errs)
    dpa_rows = timing_dpa(errs)
    # the paper's Fig. 5/7 ladder (FMA -> DPA2 -> DPA4) at 4096^3
    log("[timing] ladder at 4096^3, Top/s by events / by device time: "
        + ", ".join(f"{v} {2 * 4096 ** 3 / r['ms'] / 1e9:.1f} / "
                    f"{2 * 4096 ** 3 / r['device_ms'] / 1e9:.1f}"
                    for v, r in ((v, dpa_rows[(f"dpa_matmul/{v}", 4096)])
                                 for v in DPA_IN)))
    transpose_row = timing_transpose(
        errs, dpa_rows[("dpa_matmul/dpa4", 4096)]["transpose_device_ms"])
    phase_cli()
    # flash on each route at its own path's shape: wgmma at the serve's
    # largest prefill (bf16), launches from the serve phase; ffma at the
    # f32 smoke model's prefill, launches from that model (its bf16 times
    # at the serve shapes are in the log); ms, plain and library by CUDA
    # events, the device times beside them; each error the largest over
    # the kernels phase and the timing shapes
    top = max(flash_rows["wgmma"], key=lambda r: (r["s"], r["q_offset"]))
    top["timed_at"] = (
        f"bf16 q[1,{cfg.num_heads},{top['s']},{cfg.head_dim}] "
        f"kv[1,{cfg.num_kv_heads},{top['t']},{cfg.head_dim}] q_offset "
        f"{top['q_offset']} (the serve's largest prefill)")
    timed = {"wgmma": (launches["flash_attention/wgmma"], top),
             "ffma": (f32_launches, ffma_row)}
    kernels = []
    for route, (n, top) in timed.items():
        kernels.append({
            "name": f"flash_attention/{route}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": n,
            "max_abs_err": max([flash_errs[route], top["max_abs_err"]]
                               + [r["max_abs_err"]
                                  for r in flash_rows[route]]),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "device_ms",
                                   "library_device_ms", "timed_at")},
        })
    # STREAM at 128 MiB f32, dpa_matmul at 4096^3; each error is the
    # largest over every case the kernel was held at
    for name, line in STREAM_REPLACES.items():
        kernels.append(dict(name=name, route="cuda",
                            source="src/repro_torch/csrc/stream.cu",
                            replaces=f"src/repro/kernels/stream/stream.py:"
                                     f"{line}",
                            launches=launches[name],
                            **stream_rows[name]))
    for name in DPA_NAMES:
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/dpa_matmul.cu",
            replaces="src/repro/kernels/dpa_matmul/dpa_matmul.py:42",
            launches=launches[name],
            **dpa_rows[(name, 4096)]))
    # the transpose that dpa4's wgmma route runs before each product: no
    # TPU kernel of its own, half of the port of dpa_matmul's dpa4 variant
    kernels.append(dict(
        name=TRANSPOSE_NAME, route="cuda",
        source="src/repro_torch/csrc/dpa_matmul.cu",
        replaces="src/repro/kernels/dpa_matmul/dpa_matmul.py:42",
        part_of="dpa_matmul/dpa4",
        launches=launches[TRANSPOSE_NAME], **transpose_row))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
