"""Chip smoke test for the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which must pass (any failure exits non-zero):

1. build    — compile every CUDA kernel of the serving path from the
              repository's sources (one nvcc per source, all in parallel).
2. kernels  — hold each kernel against its plain PyTorch version on the card
              (flash attention: D 16/128, Hkv = H and 1, ragged S and T,
              causal with and without q_offset, a window, bf16 and f32).
3. small    — the smoke model in f32 on the card agrees with the same
              weights on the host (plain versions), logits and tokens.
4. serve    — granite-20b at its published width (bf16 weights made on the
              card from a seed) through ContinuousEngine: 8 requests, batch
              4, max_seq 512, 32 new tokens each, four sharing a 128-token
              prefix. The kernel launch counts are zeroed just before and
              read just after; every kernel of the path must have run.
5. profile  — where the time goes in one full-width decode step and one
              256-token prefill: host time, device-busy time, kernel count.
6. timing   — each kernel at the serve phase's prefill shapes, held
              against its plain version there (bf16 and f32) and timed
              beside it, a PyTorch library call computing the same
              function, and its bound on the card.
7. cli      — `python -m repro_torch.launch.serve --arch granite-20b
              --smoke` on the card.

The line before the last is the kernels JSON, the one before it the card's
name and power limit; the last line is the device JSON.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 without them,
# HBM3 bandwidth
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
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
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def phase_kernels():
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for (b, h, hkv, s, t, d, causal, win, off) in FLASH_CASES:
            q = torch.randn(b, h, s, d, device="cuda", generator=g).to(dt)
            k = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dt)
            v = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dt)
            got = ops.flash_attention(q, k, v, causal=causal, window=win,
                                      q_offset=off)
            want = ref.attention(q, k, v, causal=causal, window=win,
                                 q_offset=off)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = FLASH_TOL[dname]
            log(f"[kernels] flash {dname} B{b} H{h} Hkv{hkv} S{s} T{t} D{d} "
                f"causal={causal} window={win} q_offset={off}: "
                f"max|err| {err:.3e} (tol {tol:g})")
            if not err <= tol:
                raise AssertionError(f"flash kernel disagrees: {err} > {tol}")


def phase_small():
    """Smoke model, f32: the card (flash kernel) against the host (plain
    versions) on the same weights and tokens."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("granite-20b").replace(dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(1), "cpu")
    gpu = _to_cuda(cpu)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 37))
    out = {}
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
    log(f"[small] smoke f32 card vs host: max|logit err| {err:.3e} "
        f"(tol 1e-4), same argmax {same_tok}, finite {finite}")
    if not (err <= 1e-4 and same_tok and finite):
        raise AssertionError("card and host disagree on the smoke model")


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
    n_syncs = sum("synchronizing CUDA operation" in str(w.message)
                  for w in caught)
    n_tok = stats["tokens_decoded"]
    energy = stats["energy_j"]
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
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    h, hkv, d, t = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    SERVE["max_seq"])
    rows = []
    for s, off in shapes:
        g = torch.Generator(device="cuda")
        g.manual_seed(s + off)
        q = torch.randn(1, h, s, d, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        k = torch.randn(1, hkv, t, d, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        v = torch.randn(1, hkv, t, d, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        mask = (torch.arange(t, device="cuda")[None, :]
                <= torch.arange(s, device="cuda")[:, None] + off)
        ms = cuda_timed(lambda: ops.flash_attention(q, k, v, q_offset=off))
        plain_ms = cuda_timed(lambda: ref.attention(q, k, v, q_offset=off),
                              iters=5)
        lib_ms = cuda_timed(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        # held at the stated tolerance on these very inputs, in bf16 and f32
        errs = {}
        for dname in ("bfloat16", "float32"):
            qq, kk, vv = (x.to(getattr(torch, dname)) for x in (q, k, v))
            errs[dname] = (ops.flash_attention(qq, kk, vv, q_offset=off)
                           .float() - ref.attention(qq, kk, vv, q_offset=off)
                           .float()).abs().max().item()
            if not errs[dname] <= FLASH_TOL[dname]:
                raise AssertionError(
                    f"flash kernel disagrees at S {s} q_offset {off} in "
                    f"{dname}: {errs[dname]} > {FLASH_TOL[dname]}")
        err = errs["bfloat16"]
        n_bytes, n_ops = flash_work(s, t, d, h, hkv, off, 2)
        t_bytes = n_bytes / PEAK_BYTES * 1e3
        t_ops = n_ops / PEAK_OPS["bfloat16"] * 1e3
        row = dict(s=s, q_offset=off, t=t, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   max_abs_err=float(err))
        rows.append(row)
        log(f"[timing] flash bf16 q[1,{h},{s},{d}] kv[1,{hkv},{t},{d}] "
            f"q_offset {off}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), max|err| bf16 {err:.3e} (tol "
            f"{FLASH_TOL['bfloat16']:g}), f32 {errs['float32']:.3e} (tol "
            f"{FLASH_TOL['float32']:g})")
    return rows


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
    phase_build()
    phase_kernels()
    phase_small()
    cfg, eng, launches, shapes = phase_serve(card)
    phase_profile(eng)
    del eng                                    # frees the 56 GB of weights
    rows = phase_timing(cfg, shapes)
    phase_cli()
    # the kernels line times the serve's largest prefill shape; its error
    # is the largest over all the serve's shapes
    top = max(rows, key=lambda r: (r["s"], r["q_offset"]))
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:22",
        "launches": launches["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
    }]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
