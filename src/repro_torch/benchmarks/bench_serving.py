"""Continuous vs static batching at equal batch size — the reference's
``benchmarks/bench_serving.py`` on the port, every scenario, on the CUDA
card unless ``--device cpu`` asks for the host.

A workload with mixed generation lengths is served twice through the same
smoke model: the static engine runs it in sequential batch groups (every
group decodes until its longest request finishes), the continuous engine
recycles slots so freed capacity is refilled mid-decode. Reports decode
tokens/s for both, the speedup (acceptance gate: >= 1.5x), and per-request
J/token from the tag-bus energy attribution.

A retrace scenario serves prompts of N *distinct* lengths through the
continuous engine with prefill bucketing off vs on: exact-length prefill
makes one signature per length, bucketed prefill is bounded by the bucket
count. Reports end-to-end tokens/s for both (gate: >= 2x from bucketing),
the signature counts, and asserts the generated tokens are identical.

A shared-prefix scenario serves N requests sharing a long system prompt
with the radix prefix cache off vs on: with the cache the shared prefix
prefills once. Reports prefill tokens computed vs served, the hit rate,
end-to-end tokens/s (gate: >= 2x from prefix caching) and J/token, and
asserts cached tokens are identical to cold.

A mixed-family scenario models the paper's heterogeneous node: one request
stream alternating between a transformer and an SSM (``--family-arch``,
xlstm-1.3b), each served by its own continuous engine through its
family's ``CacheAdapter`` (paged KV vs carried recurrent state). Reports
per-family and combined tok/s and J/token with the signature counts.

A span-overhead scenario prices the observability layer: the per-step
span emission cost (microbenched in the ``decode_step`` shape the engine
emits) over the measured mean decode-step wall, in a ``{"value": ...,
"budget": 0.05}`` row.

Each gate prints PASS or FAIL; a FAIL is a reading, and ``main`` returns
the continuous-vs-static speedup. ``--json PATH`` dumps the rows;
``--trace-out PATH`` exports the shared-prefix cached run's span timeline
as Perfetto/chrome-trace JSON with per-span attributed joules. The joules
are modeled (the ``H100_SXM`` power model over measured windows), as every
joule of the port is.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving \
        [--device cpu] [--json PATH]

(also ``python -m repro_torch.benchmarks.run --only serving``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.benchmarks.common import BenchRows
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.obs import write_chrome_trace
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine

# mixed lengths: the static engine pays max(group) steps per group, the
# continuous engine only pays for tokens actually generated
MAX_NEW_PATTERN = [2, 4, 8, 32]


def make_requests(cfg, n, prompt_len, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    prompt_len).astype(np.int32),
                    max_new_tokens=MAX_NEW_PATTERN[i % len(MAX_NEW_PATTERN)])
            for i in range(n)]


def run_static(model, params, cfg, args):
    eng = ServeEngine(model, params, batch_size=args.batch,
                      max_seq=args.max_seq)
    eng.serve(make_requests(cfg, args.batch, args.prompt_len, seed=99))  # warmup
    reqs = make_requests(cfg, args.requests, args.prompt_len)
    tokens = dec_s = 0.0
    for i in range(0, len(reqs), args.batch):
        st = eng.serve(reqs[i:i + args.batch])
        tokens += st["tokens_decoded"]
        dec_s += st["decode_s"]
    return reqs, tokens, dec_s


def run_continuous(model, params, cfg, args):
    eng = ContinuousEngine(model, params, batch_size=args.batch,
                           max_seq=args.max_seq)
    eng.serve(make_requests(cfg, args.batch, args.prompt_len, seed=99))  # warmup
    eng.reset_metrics()
    reqs = make_requests(cfg, args.requests, args.prompt_len)
    st = eng.serve(reqs)
    return reqs, st, eng


def make_mixed_requests(cfg, lengths, max_new, seed=0):
    """One request per entry of ``lengths`` — every prompt a distinct
    length, the production traffic shape that retraces exact-length
    prefill once per request."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=max_new)
            for i, n in enumerate(lengths)]


def run_mixed(model, params, cfg, args, buckets):
    eng = ContinuousEngine(model, params, batch_size=args.batch,
                           max_seq=args.mixed_max_seq,
                           prefill_buckets=buckets)
    # warm only the decode path (fixed [B,1] shape) + one prefill length;
    # the point of the scenario is cold prefill on unseen lengths
    eng.serve(make_mixed_requests(cfg, [args.mixed_min_len] * args.batch,
                                  args.mixed_max_new, seed=99))
    eng.reset_metrics()
    lengths = [args.mixed_min_len + i for i in range(args.mixed_lengths)]
    reqs = make_mixed_requests(cfg, lengths, args.mixed_max_new)
    t0 = time.perf_counter()
    st = eng.serve(reqs)
    st["wall_s"] = time.perf_counter() - t0
    return reqs, st


def make_shared_prefix_requests(cfg, n, prefix_len, tail_len, max_new,
                                seed=0):
    """N prompts = one shared system prefix + per-request distinct tails —
    the traffic shape prefix caching exists for."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, prefix_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = np.random.default_rng(seed * 1000 + i + 1).integers(
            0, cfg.vocab_size, tail_len).astype(np.int32)
        out.append(Request(i, np.concatenate([shared, tail]),
                           max_new_tokens=max_new))
    return out


def init_params(model, dev, seed=0):
    """Random weights on ``dev`` from ``seed`` (the reference's
    ``model.init(jax.random.key(seed))``)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model.init(gen, dev)


def run_mixed_family(args, transformer):
    """One interleaved request stream across a heterogeneous pair of
    engines: even requests hit the transformer (paged-KV adapter), odd
    requests the SSM (recurrent adapter). Each engine serves its
    subsequence; combined throughput charges the serialized wall, the
    host cost of hosting both families."""
    t_cfg, t_model, t_params = transformer
    s_cfg = configs.get_smoke(args.family_arch)
    s_model = build_model(s_cfg)
    s_params = init_params(s_model, t_params["embedding"].device)
    engines = {
        "transformer": (t_cfg, ContinuousEngine(
            t_model, t_params, batch_size=args.batch, max_seq=args.max_seq)),
        "ssm": (s_cfg, ContinuousEngine(
            s_model, s_params, batch_size=args.batch, max_seq=args.max_seq)),
    }
    stream = [("transformer" if i % 2 == 0 else "ssm", i)
              for i in range(args.family_requests)]
    out = {}
    for key, (cfg, eng) in engines.items():
        eng.serve(make_requests(cfg, args.batch, args.prompt_len, seed=99))
        eng.reset_metrics()
        reqs = make_requests(cfg, args.family_requests, args.prompt_len)
        mine = [reqs[i] for k, i in stream if k == key]
        t0 = time.perf_counter()
        st = eng.serve(mine)
        st["wall_s"] = time.perf_counter() - t0
        out[key] = st
    return out


def run_span_overhead(model, params, cfg, args, eng, st):
    """Fractional decode-throughput cost of span emission.

    Comparing whole-run tok/s with tracing on vs off drowns the signal in
    run-to-run variance on shared runners (the span work is a few µs
    against ~ms steps), so this measures the two factors directly instead:
    the per-step span cost (microbenched on the live engine's tracer —
    exactly the ``decode_step`` shape the engine emits: span + step gauges
    as attrs + window ref + end) over the measured mean decode-step wall
    from the continuous-batching scenario just run. Best of N microbench
    repeats sheds scheduler noise; the ratio is the first-order tok/s loss.
    """
    step_wall = st["decode_s"] / max(st["decode_steps"], 1)
    tr = eng.tracer
    n = 2000
    span_cost = float("inf")
    for _ in range(args.overhead_repeats):
        tr.clear()
        t0 = time.perf_counter()
        for i in range(n):
            with tr.span("decode_step", track="engine", active=4,
                         queue_depth=8, free_blocks=12,
                         evictable_blocks=3) as sp:
                sp.set("window", i)
        span_cost = min(span_cost, (time.perf_counter() - t0) / n)
    tr.clear()
    overhead = span_cost / step_wall if step_wall else 0.0
    return span_cost, step_wall, overhead


def run_shared_prefix(model, params, cfg, args, prefix_cache):
    eng = ContinuousEngine(model, params, batch_size=args.batch,
                           max_seq=args.prefix_max_seq,
                           prefix_cache=prefix_cache)
    # warmup compiles both prefill shapes the measured phase needs: the
    # full-prompt bucket (cold misses) and the tail bucket (cache hits);
    # reset_metrics clears the trie so the measured phase starts cold
    eng.serve(make_shared_prefix_requests(
        cfg, args.batch, args.prefix_len, args.prefix_tail,
        args.prefix_max_new, seed=99))
    eng.reset_metrics()
    reqs = make_shared_prefix_requests(
        cfg, args.prefix_requests, args.prefix_len, args.prefix_tail,
        args.prefix_max_new)
    t0 = time.perf_counter()
    st = eng.serve(reqs)
    st["wall_s"] = time.perf_counter() - t0
    return reqs, st, eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--device", default=None,
                    help="torch device: the CUDA card by default; 'cpu' "
                         "runs on the host")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--mixed-lengths", type=int, default=32,
                    help="distinct prompt lengths in the retrace scenario")
    ap.add_argument("--mixed-min-len", type=int, default=4)
    ap.add_argument("--mixed-max-new", type=int, default=4)
    ap.add_argument("--mixed-max-seq", type=int, default=64)
    ap.add_argument("--prefix-requests", type=int, default=16,
                    help="requests in the shared-prefix scenario")
    ap.add_argument("--prefix-len", type=int, default=96,
                    help="shared system-prompt length")
    ap.add_argument("--prefix-tail", type=int, default=4,
                    help="distinct per-request tail length")
    ap.add_argument("--prefix-max-new", type=int, default=2)
    ap.add_argument("--prefix-max-seq", type=int, default=128)
    ap.add_argument("--family-arch", default="xlstm-1.3b",
                    help="recurrent-family arch for the mixed-family "
                         "scenario")
    ap.add_argument("--family-requests", type=int, default=8,
                    help="requests in the interleaved mixed-family stream")
    ap.add_argument("--overhead-repeats", type=int, default=3,
                    help="span-emission microbench repeats (best-of-N "
                         "sheds scheduler noise)")
    ap.add_argument("--span-budget", type=float, default=0.05,
                    help="max fraction of decode tok/s span emission may "
                         "cost (budget row, gated absolutely)")
    ap.add_argument("--json", default=None,
                    help="dump the rows as JSON")
    ap.add_argument("--trace-out", default=None,
                    help="write the shared-prefix cached run's Perfetto "
                         "timeline (spans + per-span attributed joules)")
    args = ap.parse_args(argv)
    rows = BenchRows()

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    model = build_model(cfg)
    params = init_params(model, dev)

    s_reqs, s_tokens, s_dec = run_static(model, params, cfg, args)
    c_reqs, c_st, c_eng = run_continuous(model, params, cfg, args)

    s_tps = s_tokens / s_dec if s_dec else 0.0
    c_tps = c_st["decode_tok_per_s"]
    speedup = c_tps / s_tps if s_tps else float("inf")

    assert all(a.output == b.output for a, b in zip(s_reqs, c_reqs)), \
        "engines disagree on generated tokens"

    rows.record("serve/static_decode", 1.0 / s_tps if s_tps else 0.0,
                f"{s_tps:.1f}tok/s")
    rows.record("serve/continuous_decode", 1.0 / c_tps if c_tps else 0.0,
                f"{c_tps:.1f}tok/s;speedup={speedup:.2f}x_vs_static;"
                f"recycles={c_st['slots_recycled']}")
    total_j = c_st.get("energy_j", 0.0)
    rows.record("serve/continuous_energy", c_st["decode_s"],
                f"{total_j:.2f}J_total;"
                f"{total_j / max(c_st['tokens_decoded'], 1):.3f}J/token")

    # -- retrace scenario: N distinct prompt lengths, bucketing off vs on --
    u_reqs, u_st = run_mixed(model, params, cfg, args, buckets="off")
    b_reqs, b_st = run_mixed(model, params, cfg, args, buckets="auto")
    assert all(a.output == b.output for a, b in zip(u_reqs, b_reqs)), \
        "bucketed prefill changed generated tokens"

    def _e2e_tps(st):
        # wall time, not prefill_s+decode_s: the retrace cost shows up
        # partly as host-loop overhead between steps
        return st["tokens_decoded"] / st["wall_s"] if st["wall_s"] else 0.0

    u_tps, b_tps = _e2e_tps(u_st), _e2e_tps(b_st)
    bucket_speedup = b_tps / u_tps if u_tps else float("inf")
    rows.record("serve/mixed_unbucketed", u_st["wall_s"],
                f"{u_tps:.1f}tok/s_e2e;lengths={args.mixed_lengths}",
                compiles=u_st["prefill_compiles"])
    rows.record("serve/mixed_bucketed", b_st["wall_s"],
                f"{b_tps:.1f}tok/s_e2e;speedup={bucket_speedup:.2f}x;"
                f"buckets={b_st['prefill_buckets']}",
                compiles=b_st["prefill_compiles"])
    # bucketed prefill signatures are bounded by the bucket count
    rows.record("serve/prefill_compiles", b_st["prefill_s"],
                f"compiles={b_st['prefill_compiles']};"
                f"unbucketed={u_st['prefill_compiles']}",
                compiles=b_st["prefill_compiles"])

    # -- shared-prefix scenario: radix prefix cache off vs on --------------
    p_reqs, p_st, _ = run_shared_prefix(model, params, cfg, args,
                                        prefix_cache=False)
    h_reqs, h_st, h_eng = run_shared_prefix(model, params, cfg, args,
                                            prefix_cache=True)
    assert all(a.output == b.output for a, b in zip(p_reqs, h_reqs)), \
        "prefix-cache hits changed generated tokens"

    p_tps, h_tps = _e2e_tps(p_st), _e2e_tps(h_st)
    prefix_speedup = h_tps / p_tps if p_tps else float("inf")
    hit = h_st["prefix_cache"]
    h_jtok = h_st.get("energy_j", 0.0) / max(h_st["tokens_decoded"], 1)
    p_jtok = p_st.get("energy_j", 0.0) / max(p_st["tokens_decoded"], 1)
    rows.record("serve/prefix_cold", p_st["wall_s"],
                f"{p_tps:.1f}tok/s_e2e;"
                f"prefill_computed={p_st['prefill_tokens_computed']};"
                f"{p_jtok:.3f}J/token",
                compiles=p_st["prefill_compiles"])
    # hit_rate rides in the JSON row
    rows.record("serve/prefix_cached", h_st["wall_s"],
                f"{h_tps:.1f}tok/s_e2e;speedup={prefix_speedup:.2f}x;"
                f"hit_rate={hit['hit_rate']:.2f};"
                f"prefill_computed={h_st['prefill_tokens_computed']};"
                f"{h_jtok:.3f}J/token",
                compiles=h_st["prefill_compiles"],
                hit_rate=hit["hit_rate"])
    # auxiliary signatures (slot reset / block zero / block copy) get their
    # OWN row — the other rows keep their compile semantics
    aux = {}
    for st in (c_st, h_st):
        for nm, n in st.get("compiles", {}).items():
            if nm not in ("prefill", "decode"):
                aux[nm] = aux.get(nm, 0) + n
    rows.record("serve/aux_compiles", 0.0,
                ";".join(f"{k}={v}" for k, v in sorted(aux.items())) or "none",
                compiles=sum(aux.values()))

    # -- mixed-family scenario: transformer + SSM interleaved --------------
    fam = run_mixed_family(args, (cfg, model, params))

    def _fam_metrics(st):
        tps = _e2e_tps(st)
        jtok = st.get("energy_j", 0.0) / max(st["tokens_decoded"], 1)
        n_compiles = sum(st.get("compiles", {}).values())
        return tps, jtok, n_compiles

    fam_rows = {k: _fam_metrics(st) for k, st in fam.items()}
    for key, (tps, jtok, n_compiles) in sorted(fam_rows.items()):
        st = fam[key]
        rows.record(f"serve/mixed_family_{key}", st["wall_s"],
                    f"{tps:.1f}tok/s_e2e;{jtok:.3f}J/token;"
                    f"adapter={st['adapter']}",
                    compiles=n_compiles)
    fam_wall = sum(st["wall_s"] for st in fam.values())
    fam_tokens = sum(st["tokens_decoded"] for st in fam.values())
    fam_j = sum(st.get("energy_j", 0.0) for st in fam.values())
    fam_tps = fam_tokens / fam_wall if fam_wall else 0.0
    rows.record("serve/mixed_family", fam_wall,
                f"{fam_tps:.1f}tok/s_combined;"
                f"{fam_j / max(fam_tokens, 1):.3f}J/token",
                compiles=sum(c for _, _, c in fam_rows.values()))

    # -- span-overhead scenario: observability must be near-free -----------
    span_cost, step_wall, overhead = run_span_overhead(
        model, params, cfg, args, c_eng, c_st)
    rows.record("serve/span_overhead", span_cost,
                f"span={span_cost*1e6:.2f}us;step={step_wall*1e6:.0f}us;"
                f"overhead={overhead:.2%}",
                value=overhead, budget=args.span_budget)

    if args.trace_out:
        write_chrome_trace(
            args.trace_out, h_eng.tracer,
            session=h_eng.tel.session if h_eng.tel is not None else None,
            meta={"process": "bench-serving", "arch": cfg.name,
                  "scenario": "shared-prefix-cached"})
        print(f"timeline -> {args.trace_out}")
    rows.dump(args.json)
    print(f"\nstatic    : {s_tokens:.0f} tokens in {s_dec*1e3:.0f} ms decode "
          f"({s_tps:.1f} tok/s)")
    print(f"continuous: {c_st['tokens_decoded']} tokens in "
          f"{c_st['decode_s']*1e3:.0f} ms decode ({c_tps:.1f} tok/s), "
          f"{c_st['slots_recycled']} slot recycles, "
          f"peak {c_st['peak_active']} active")
    print(f"speedup   : {speedup:.2f}x "
          f"({'PASS' if speedup >= 1.5 else 'FAIL'} >= 1.5x gate)")
    print(f"\nretrace scenario ({args.mixed_lengths} distinct prompt lengths):")
    print(f"  unbucketed: {u_st['prefill_compiles']} prefill compiles, "
          f"{u_tps:.1f} tok/s end-to-end")
    print(f"  bucketed  : {b_st['prefill_compiles']} prefill compiles "
          f"(buckets={b_st['prefill_buckets']}), {b_tps:.1f} tok/s end-to-end")
    print(f"  bucketing speedup: {bucket_speedup:.2f}x "
          f"({'PASS' if bucket_speedup >= 2.0 else 'FAIL'} >= 2x gate)")
    print(f"\nshared-prefix scenario ({args.prefix_requests} requests, "
          f"{args.prefix_len}-token shared prefix, "
          f"{args.prefix_tail}-token tails, kv block "
          f"{h_st['kv_block_size']}):")
    print(f"  prefix cache off: {p_st['prefill_tokens_computed']} prefill "
          f"tokens computed / {p_st['prompt_tokens']} served, "
          f"{p_tps:.1f} tok/s e2e, {p_jtok:.3f} J/token")
    print(f"  prefix cache on : {h_st['prefill_tokens_computed']} prefill "
          f"tokens computed / {h_st['prompt_tokens']} served "
          f"(hit rate {hit['hit_rate']:.0%}, "
          f"{hit['cached_tokens']} tokens cached), "
          f"{h_tps:.1f} tok/s e2e, {h_jtok:.3f} J/token")
    print(f"  prefix-cache speedup: {prefix_speedup:.2f}x "
          f"({'PASS' if prefix_speedup >= 2.0 else 'FAIL'} >= 2x gate)")
    print(f"\nmixed-family scenario ({args.family_requests} requests "
          f"interleaved transformer/{args.family_arch}):")
    for key, (tps, jtok, n_compiles) in sorted(fam_rows.items()):
        print(f"  {key:11s}: {fam[key]['tokens_decoded']} tokens, "
              f"{tps:.1f} tok/s e2e, {jtok:.3f} J/token, "
              f"{n_compiles} compiles [{fam[key]['adapter']}]")
    print(f"  combined   : {fam_tps:.1f} tok/s over the serialized wall, "
          f"{fam_j / max(fam_tokens, 1):.3f} J/token")
    print(f"\nspan-overhead scenario (best of {args.overhead_repeats} "
          f"microbench repeats):")
    print(f"  decode_step span emission: {span_cost*1e6:.2f} us/step")
    print(f"  measured decode step wall: {step_wall*1e6:.0f} us")
    print(f"  overhead: {overhead:.2%} "
          f"({'PASS' if overhead <= args.span_budget else 'FAIL'} <= "
          f"{args.span_budget:.0%} budget)")
    print("\nper-request energy (tag-bus attribution):")
    for r in c_reqs:
        print(f"  req {r.req_id:2d}: {len(r.output):2d} tokens  "
              f"{r.energy_j:7.2f} J  "
              f"{r.energy_j / max(len(r.output), 1):6.2f} J/token")
    parts = sum(r.energy_j for r in c_reqs)
    print(f"  board total {total_j:.2f} J, request sum {parts:.2f} J")
    return speedup


def run(dev):
    """The bench runner's entry (``--only serving``) on ``dev``."""
    main(["--device", dev.type])


if __name__ == "__main__":
    main()
