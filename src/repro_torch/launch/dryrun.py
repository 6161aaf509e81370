"""Dry-run: count every (architecture x input shape) cell on the production
meshes without a device, and record the roofline's inputs (the
reference's ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 fake CPU devices and
reads the executable. The port has no compiler: it runs ONE RANK's step
of the cell on the meta device (shapes and dtypes, no storage), on a
``launch.mesh.RankMesh`` whose collectives are shape-only stand-ins,
under the op counter (``perf.op_cost``). Nothing is allocated on any
device and no process group is opened. A train cell runs
``ShardedTrainStep`` (the rank's rows of each microbatch, each layer's
leaves gathered where the layer runs, its share of the heads, MLP width
and vocabulary computed over ``model``, the gradients reduce-scattered
to the rank's blocks, AdamW on them: what a rank of the port runs); a
serve cell runs ``serve.step.ShardedServeStep`` under the reference's
``serve_rules``: the model's ``prefill`` or ``decode_step`` on the rank's
batch rows and its blocks of the bf16 parameters and of the caches, each
layer's leaves gathered where the layer runs, heads, MLP width,
vocabulary and experts computed over ``model``, the caches split over KV
heads or, where those do not divide ``model``, over sequence (decode
combines the blocks' partial softmaxes). The recurrent families split
their compute over ``model`` too, in training and serving: zamba2's
Mamba2 heads (4 of 64 a rank at model 16) and inner channels, xlstm's
inner channels (its 4 heads run whole on every rank at model 16),
whisper's MLP width (its 12 heads run whole); their states split over
heads where those divide, and a batch of one (long_500k) splits zamba2's
shared-attention caches over sequence on ``("pod", "data")`` and over KV
heads on ``model``.

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records land in build/dryrun/<mesh>/<arch>__<shape>.json and are read by
the port's roofline report (``repro_torch.benchmarks.bench_roofline``).
Each holds the reference's keys, ``peak_gb`` (decimal GB) and ``fits``:
the rank's peak live bytes at most ``H100_SXM.mem_gb``.

``recurrent_serve_count`` counts a recurrent family's serve on one
device as its adapter runs it (the batch's rows and the working state
live) and finds the prefill chunk cap that fits a limit;
``long_serve_count`` finds the batch at which a flat family serves long
positions by the cells' counts, and ``paged_serve_count`` counts that
serve through the paged pool as its adapter runs it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.hw import H100_SXM
from repro_torch.core.tracing import TraceStats, counting_call
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models import abstract_params, build_model, token_batch_specs
from repro_torch.models.registry import serving_caps
from repro_torch.parallel.sharding import NamedSharding, mesh_shape
from repro_torch.perf import op_cost, roofline, step_analysis
from repro_torch.serve.state import make_adapter
from repro_torch.serve.step import (ShardedServeStep, abstract_cache,
                                    bucket_for, capped_chunks, cell_rules)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig, tree_map
from repro_torch.train.step import (ShardedTrainStep, StepConfig, TrainState,
                                    batch_specs, state_specs)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# per-shape microbatching (the reference's choice)
N_MICRO = {"train_4k": 16}

#: variants whose flag the port's model does not have (XLA scheduling and
#: precision knobs of the reference)
XLA_ONLY = ("barrier", "carry_barrier", "scores_bf16")


def serve_rules(cfg, shape, mesh):
    """Cell-specific sharding-rule overrides for serving
    (``serve.step.cell_rules``)."""
    return cell_rules(cfg, shape.global_batch, mesh)


FSDP_RULES = {
    # pure ZeRO-3 layout: every param's embed dim + the batch sharded over
    # the WHOLE mesh; no tensor parallelism (no activation all-reduces)
    "embed": ("pod", "data", "model"),
    "vocab": None, "heads": None, "kv_heads": None, "mlp": None,
    "experts": None, "ssm_inner": None,
    "batch": ("pod", "data", "model"),
    "act_heads": None, "act_kv_heads": None, "act_experts": None,
    "act_vocab": None, "act_mlp": None,
}

EP_RULES = {
    # MoE hybrid: ZeRO-3 everywhere (batch + param embed dims over the whole
    # mesh) EXCEPT experts, which shard over ``model`` and run via
    # all-to-all EP — no expert-weight gathers, dense compute fully
    # data-parallel
    "embed": ("pod", "data", "model"),
    "vocab": None, "heads": None, "kv_heads": None, "mlp": None,
    "experts": "model", "ssm_inner": None,
    "batch": ("pod", "data", "model"),
    "act_heads": None, "act_kv_heads": None, "act_experts": None,
    "act_vocab": None, "act_mlp": None,
}


def layout_rules(layout: str, sizes) -> dict:
    """The sharding rules of a train layout (``2d``: None, the default
    rules; ``fsdp``; ``ep``), without the axes absent from a mesh of
    ``sizes``."""
    rules = {"2d": None, "fsdp": FSDP_RULES, "ep": EP_RULES}[layout]
    if rules is None:
        return None
    return {k: (tuple(a for a in v if a in sizes)
                if isinstance(v, tuple) else v) for k, v in rules.items()}


def _meta(shapes, dtype):
    """Meta tensors of a shape tree."""
    return tree_map(lambda s: torch.empty(s, dtype=dtype, device="meta"),
                    shapes)


def _cut(tree, spec_tree, mesh):
    """The rank's blocks of ``tree`` (nested dicts and tuples of
    tensors) laid out by ``spec_tree`` on ``mesh`` (a ``RankMesh``)."""
    if isinstance(tree, torch.Tensor):
        return NamedSharding(mesh, spec_tree).block(tree)
    if isinstance(tree, dict):
        return {k: _cut(tree[k], spec_tree[k], mesh) for k in tree}
    return tuple(_cut(t, s, mesh) for t, s in zip(tree, spec_tree))


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch: str, shape_name, mesh, variant=None, cfg=None):
    """Returns (fn, args, cfg, shape, info): ``fn(*args)`` runs one rank's
    step of the cell on meta tensors.

    ``mesh``: an abstract mesh (``make_production_mesh``, a dict of axis
    sizes); ``shape_name``: a name of ``SHAPES`` or a ``ShapeConfig``;
    ``cfg``: the config to run (``configs.get(arch)`` by default; a cut
    depth, for example). ``variant`` (perf hillclimbing): {layout:
    "2d"|"fsdp"|"ep", n_micro: int, cast_once: bool, vocab_chunks: int,
    moe_shard_map: bool}. ``info["argument_bytes"]`` holds the rank's
    argument bytes from the specs."""
    variant = dict(variant or {})
    refused = [k for k in XLA_ONLY if variant.get(k)]
    if refused:
        raise ValueError(f"variant {refused}: an XLA knob the port's model "
                         "has no counterpart for")
    sizes = mesh_shape(mesh)
    base = cfg if cfg is not None else configs.get(arch)
    cfg = base.adapt_for_mesh(sizes.get("model", 1))
    shape = _shape(shape_name)
    rank = RankMesh(sizes)
    n_chips = rank.size

    if shape.kind == "train":
        layout = variant.get("layout", "2d")
        rules = layout_rules(layout, sizes)
        if layout == "ep":
            variant = dict(variant, moe_shard_map=1, n_micro=1)
        if rules is not None:
            if layout == "fsdp" and shape.global_batch % n_chips:
                raise ValueError("fsdp layout needs batch divisible by chip "
                                 "count")
        kw = ({"moe_impl": "shard_map"} if variant.get("moe_shard_map")
              and cfg.is_moe else {})
        model = build_model(cfg, rank, shd_rules=rules, **kw)
        shapes, axes = abstract_params(model)
        dp_total = n_chips // sizes.get("model", 1)
        default_micro = 1 if layout == "fsdp" else min(
            N_MICRO.get(shape.name, 8),
            max(shape.global_batch // (dp_total or 1), 1))
        n_micro = variant.get("n_micro", default_micro)
        step_cfg = StepConfig(num_microbatches=n_micro,
                              cast_params_once=bool(variant.get("cast_once")),
                              vocab_chunks=variant.get("vocab_chunks", 1))
        step = ShardedTrainStep(model, OptConfig(), step_cfg, rank, rules)
        params = _meta(shapes, getattr(torch, cfg.param_dtype))
        state = TrainState(params, opt_mod.abstract_opt_state(params))
        batch = token_batch_specs(cfg, shape)
        arg_bytes = (
            step_analysis.rank_bytes(sizes, state_specs(sizes, shapes, axes,
                                                        rules), state)
            + step_analysis.rank_bytes(sizes, batch_specs(sizes, batch,
                                                          rules), batch))
        state = step.layout(state)
        info = {"kind": "train", "n_micro": n_micro, "layout": layout,
                "variant": variant, "argument_bytes": arg_bytes}
        return step, (state, batch), cfg, shape, info

    # serving cells: bf16 params; the model runs on the rank's blocks of
    # the parameters, caches and batch rows, as the reference lays the
    # cell out (``serve.step.ShardedServeStep``)
    scfg = cfg.replace(param_dtype="bfloat16")
    rules = serve_rules(scfg, shape, rank)
    model = build_model(scfg, rank, shd_rules=rules)
    max_seq = shape.seq_len + (
        scfg.stub_prefix_len if scfg.family == "vlm" else 0)
    serve = ShardedServeStep(model, rank, shape.global_batch, max_seq)
    shapes, _ = abstract_params(model)
    params = _meta(shapes, getattr(torch, scfg.param_dtype))
    cache = abstract_cache(model, shape.global_batch, max_seq)
    arg_bytes = (step_analysis.rank_bytes(sizes, serve.param_specs, params)
                 + step_analysis.rank_bytes(sizes, serve.cache_specs, cache))
    params = serve.layout(params)
    cache = serve.layout_cache(cache)
    info = {"kind": shape.kind, "rules": str(rules)}

    if shape.kind == "prefill":
        batch = token_batch_specs(scfg, shape)
        bspecs = batch_specs(sizes, batch, rules)
        arg_bytes += step_analysis.rank_bytes(sizes, bspecs, batch)
        batch = _cut(batch, bspecs, rank)

        def fn(p, b, c):
            with torch.no_grad():
                return serve.prefill(p, b, c)

        return fn, (params, batch, cache), scfg, shape, dict(
            info, argument_bytes=arg_bytes)

    # decode: one new token against a cache of seq_len
    tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                      device="meta")
    tspec = batch_specs(sizes, {"t": tok}, rules)["t"]
    arg_bytes += step_analysis.rank_bytes(sizes, tspec, tok)
    tok = NamedSharding(rank, tspec).block(tok)
    pos = shape.seq_len - 1

    def fn(p, t, c):
        with torch.no_grad():
            return serve.decode(p, t, pos, c)

    return fn, (params, tok, cache), scfg, shape, dict(
        info, argument_bytes=arg_bytes)


def count_cell(fn, args):
    """Run ``fn(*args)`` under a memory-tracking op counter that scales
    loops; returns the counter. The arguments are live from the start."""
    counter = op_cost.OpCounter(scale_loops=True, track_memory=True)
    with counter:
        counter.track(args)
        out = fn(*args)
        del out
    return counter


def engine_decode_count(cfg, *, batch: int, max_seq: int):
    """The op counter of one device's engine decode step (bf16 weights,
    the meta device): ``decode_step`` of the model built without a mesh
    on a contiguous cache of ``batch`` x ``max_seq`` at position
    ``max_seq - 1``. It differs from the decode cell on a one-device mesh
    (``analyze_cell``) only where the mesh changes what runs: an MoE
    layer routes one group a batch shard on a mesh (one group of every
    row on one device) and ``gcd(B, 32)`` groups without one, as the
    reference's ``_moe_apply_gspmd`` does."""
    scfg = cfg.replace(param_dtype="bfloat16")
    model = build_model(scfg)
    shapes, _ = abstract_params(model)
    params = _meta(shapes, torch.bfloat16)
    cache = model.init_cache(batch, max_seq, device="meta")
    tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")

    def fn(p, t, c):
        with torch.no_grad():
            return model.decode_step(p, t, max_seq - 1, c)

    return count_cell(fn, (params, tok, cache))


def recurrent_serve_count(cfg, *, batch: int, max_seq: int, prompt: int,
                          limit=None) -> dict:
    """The peak live bytes (one device, the meta device) of serving
    ``prompt``-token requests through ``RecurrentStateAdapter`` at
    ``batch`` x ``max_seq``, and the chunk cap that fits ``limit`` bytes.

    The bf16 parameters, the batch's rows of state and the adapter's
    batch-1 working tree are live throughout. A serve's count is the
    larger of the decode step of the whole batch and the prompt's largest
    chunk at that size's last offset (its attention reads the working
    tree's whole cache whatever the offset; a smaller chunk's transients
    are a share of the largest's). The uncapped chunking (``max_chunk``
    None, the reference's) is counted first; while a count passes
    ``limit``, the cap halves below the largest chunk. A text request
    only: an audio request's first chunk also encodes its frames.

    Returns dict(cap: the first ``max_chunk`` that fits (None, uncapped,
    where ``limit`` is None), serve={cap: peak bytes}, decode: the decode
    step's, state: bytes of the adapter's trees)."""
    if serving_caps(cfg).needs_frames:
        raise ValueError(f"{cfg.name}'s requests carry frames: the count "
                         f"covers text requests only")
    scfg = cfg.replace(param_dtype="bfloat16")
    model = build_model(scfg)
    shapes, _ = abstract_params(model)
    params = _meta(shapes, torch.bfloat16)
    ad = make_adapter(model, params, batch_size=batch, max_seq=max_seq)
    ad.ensure_ready()

    def peak(fn, *args):
        counter = op_cost.OpCounter(scale_loops=True, track_memory=True)
        with torch.no_grad(), counter:
            counter.track((params, ad.caches, ad._work, args))
            out = fn(*args)
            del out
        return counter.peak_bytes

    def meta_tokens(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    decode = peak(lambda t, p: ad._decode(params, t, p, ad.caches),
                  meta_tokens(batch, 1), meta_tokens(batch))
    out = dict(cap=None, serve={}, decode=decode,
               state=sum(t.numel() * t.element_size() for t in
                         op_cost._tensors((ad.caches, ad._work))))
    cap = None
    while True:
        chunks = capped_chunks(prompt, cap)
        top = chunks[0]                  # the largest, first and repeated
        off = top * (chunks.count(top) - 1)
        out["serve"][cap] = max(decode, peak(
            lambda t: ad._chunk(params, t, None, off, ad._work),
            meta_tokens(1, top)))
        out["cap"] = cap
        if limit is None or out["serve"][cap] <= limit:
            return out
        if top == 1:
            raise ValueError(f"no chunk cap fits {limit} bytes")
        cap = top // 2


#: the batches a flat family's long serve is counted at, largest first
LONG_BATCHES = (4, 2, 1)


def long_serve_count(cfg, *, max_seq: int, limit=None) -> dict:
    """The largest of ``LONG_BATCHES`` at which a flat family serves
    ``max_seq`` positions within ``limit`` bytes, by the cells' counts (one
    device): the decode step at batch b over ``max_seq`` positions, and a
    one-row ``max_seq``-token prefill with b - 1 more rows of cache beside
    it (the serve's peak at b is the larger). Batches are counted from the
    first until one fits (all of them with ``limit`` None). Returns
    dict(batch: the first that fits, None where none does or ``limit`` is
    None; decode={b: bytes}, prefill: bytes, row: a row of cache's bytes,
    serve={b: bytes})."""
    mesh = {"data": 1, "model": 1}
    rec, _ = analyze_cell(cfg.name, ShapeConfig("long_prefill", "prefill",
                                                max_seq, 1), mesh, cfg=cfg)
    row = sum(t.numel() * t.element_size() for t in op_cost._tensors(
        build_model(cfg).init_cache(1, max_seq, device="meta")))
    out = dict(batch=None, decode={}, prefill=rec["analysis"]["peak_bytes"],
               row=row, serve={})
    for b in LONG_BATCHES:
        rec, _ = analyze_cell(cfg.name, ShapeConfig(
            "long_decode", "decode", max_seq, b), mesh, cfg=cfg)
        out["decode"][b] = rec["analysis"]["peak_bytes"]
        out["serve"][b] = max(out["decode"][b],
                              out["prefill"] + (b - 1) * row)
        if limit is not None and out["serve"][b] <= limit:
            out["batch"] = b
            return out
    return out


def paged_serve_count(cfg, *, batch: int, max_seq: int, prompt: int) -> dict:
    """The peak live bytes (one device, the meta device) of serving
    ``prompt``-token requests through ``PagedKVAdapter`` at ``batch`` x
    ``max_seq``: the bf16 parameters and the pool (``batch`` rows of
    blocks and the null block) live throughout, the decode step of the
    whole batch and a cold prefill of the prompt's bucket into one row.
    A prefix hit's tail is a smaller bucket over the same row. Returns
    dict(decode, prefill, serve: the larger, pool: the pool's bytes)."""
    scfg = cfg.replace(param_dtype="bfloat16")
    model = build_model(scfg)
    shapes, _ = abstract_params(model)
    params = _meta(shapes, torch.bfloat16)
    ad = make_adapter(model, params, batch_size=batch, max_seq=max_seq)
    if ad.kind != "paged-kv":
        raise ValueError(f"{cfg.name} serves on {ad.kind}, not paged-kv")
    ad.ensure_ready()

    def peak(fn, *args):
        counter = op_cost.OpCounter(track_memory=True)
        with torch.no_grad(), counter:
            counter.track((params, ad.caches, args))
            out = fn(*args)
            del out
        return counter.peak_bytes

    def meta_ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    bucket = bucket_for(prompt, ad.buckets)
    decode = peak(lambda t, p, tb: ad._decode(params, t, p, tb, ad.caches),
                  meta_ints(batch, 1), meta_ints(batch),
                  meta_ints(batch, ad.n_slot_blocks))
    prefill = peak(lambda t, row: ad._prefill_slot(params, t, prompt, 0, row,
                                                   ad.caches),
                   meta_ints(1, bucket), meta_ints(ad.n_slot_blocks))
    return dict(decode=decode, prefill=prefill, serve=max(decode, prefill),
                pool=sum(t.numel() * t.element_size()
                         for t in op_cost._tensors(ad.caches)))


def analyze_cell(arch, shape_name, mesh, variant=None, cfg=None):
    """Build, count and analyze one cell on ``mesh``; returns the record's
    body (without timing keys) and the counter."""
    fn, args, cfg, shape, info = build_cell(arch, shape_name, mesh,
                                            variant, cfg)
    stats = TraceStats()
    # dalek: allow[step-kwargs] one counter a cell, named after the cell as the record's jit_traces
    counted = counting_call(fn, f"{info['kind']}:{arch}/{shape.name}",
                            stats)
    counter = count_cell(counted, args)
    del args
    analysis = step_analysis.analyze(counter, info.pop("argument_bytes"))
    n_chips = RankMesh(mesh).size
    shapes, _ = abstract_params(build_model(cfg))
    n_total = roofline.count_params(shapes)
    n_active = roofline.active_params(cfg, n_total)
    mf = roofline.model_flops(cfg, shape, n_active)
    rl = roofline.compute_roofline(analysis, n_chips, mf)
    mem = analysis["memory"]
    hbm = (mem["argument_bytes"] + mem["temp_bytes"])
    mem_k = (analysis["bytes_accessed"]
             - analysis["attn_score_bytes"]) / roofline.HBM_BW
    t_k = max(rl.compute_s, mem_k, rl.collective_s)
    rec = dict(info, analysis=analysis, roofline=rl.to_dict(),
               n_params=n_total, n_params_active=n_active,
               jit_traces=stats.snapshot(),
               hbm_per_device_gb=hbm / 2 ** 30,
               hbm_adjusted_gb=(hbm - analysis["f32_hoist_bytes"]) / 2 ** 30,
               peak_gb=analysis["peak_bytes"] / 1e9,
               fits=analysis["peak_bytes"] <= H100_SXM.mem_gb * 1e9,
               memory_s_with_kernel=mem_k,
               roofline_frac_with_kernel=rl.compute_s / t_k if t_k else 0.0)
    return rec, counter


def run_cell(arch: str, shape_name: str, mesh_kind: str, force=False,
             out_dir=None):
    out_dir = pathlib.Path(out_dir or RESULTS) / mesh_kind
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        if "error" not in rec:
            print(f"[skip] {mesh_kind}/{arch}/{shape_name} (cached)")
            return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "n_chips": mesh.size}
    try:
        body, _ = analyze_cell(arch, shape_name, mesh)
        rec.update(body, wall_s=time.time() - t0)
        rl = rec["roofline"]
        print(f"[ok] {mesh_kind}/{arch}/{shape_name}: "
              f"dominant={rl['dominant']} useful={rl['useful_ratio']:.2f} "
              f"hbm={rec['hbm_per_device_gb']:.2f}GiB fits={rec['fits']} "
              f"wall={rec['wall_s']:.0f}s")
    except Exception as e:  # noqa: BLE001  (recorded; the CLI exits 1)
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["wall_s"] = time.time() - t0
        print(f"[FAIL] {mesh_kind}/{arch}/{shape_name}: {rec['error'][:300]}")
    out_path.write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help=f"records' directory (default {RESULTS})")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(configs.all_cells())
    else:
        if args.arch is None:
            ap.error("--arch (or --all) is required")
        shapes = [args.shape] if args.shape else list(
            configs.shape_cells(args.arch))
        cells = [(args.arch, s) for s in shapes]

    failures = 0
    for mesh_kind in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, mesh_kind, force=args.force,
                           out_dir=args.out_dir)
            failures += 1 if "error" in rec else 0
    print(f"done: {len(cells) * len(meshes)} cells, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
