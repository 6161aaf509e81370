"""Perf hillclimbing driver: count a (cell x variant) on the meta device,
record the three roofline terms, and write the iteration's record (the
reference's ``repro.launch.perf``).

Device-free, as the dry-run is (``launch.dryrun``): one rank's step on the
meta device with stand-in collectives; nothing is allocated on any device.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch granite-20b \\
        --shape train_4k --variant layout=fsdp,cast_once=1 --tag zero3

Variants with a meaning in the port: ``layout`` (2d, fsdp, ep),
``n_micro``, ``cast_once``, ``vocab_chunks``, ``moe_shard_map``. The
reference's XLA knobs (``barrier``, ``carry_barrier``, ``scores_bf16``)
are refused by name: the port's model has no such flag. The reference's
``--save-hlo`` has no counterpart (there is no HLO). Records land in
build/perf/<arch>__<shape>__<tag>.json.
"""
import argparse
import json
import pathlib
import time

from repro_torch.launch.dryrun import XLA_ONLY, analyze_cell
from repro_torch.launch.mesh import make_production_mesh

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "perf"

#: the variant keys the port's step and model read
VARIANTS = ("layout", "n_micro", "cast_once", "vocab_chunks", "moe_shard_map")


def parse_variant(s):
    """``k=v,k=v`` -> dict (digits as ints, true/false as bools;
    ``cast_once`` and ``moe_shard_map`` as bools). Raises ValueError for
    an XLA-only or unknown key."""
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=")
        if k in XLA_ONLY:
            raise ValueError(f"variant {k!r} is an XLA knob of the "
                             "reference; the port's model has no such flag")
        if k not in VARIANTS:
            raise ValueError(f"unknown variant {k!r} (the port's: "
                             f"{', '.join(VARIANTS)})")
        if v.isdigit():
            v = int(v)
        elif v in ("true", "false"):
            v = v == "true"
        out[k] = v
    for b in ("cast_once", "moe_shard_map"):
        if b in out:
            out[b] = bool(out[b])
    return out


def run_variant(arch, shape_name, variant, tag, mesh_kind="single",
                out_dir=None):
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    body, _ = analyze_cell(arch, shape_name, mesh, variant)
    rl = body["roofline"]
    t_step = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    t_step_k = max(rl["compute_s"], body["memory_s_with_kernel"],
                   rl["collective_s"])
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "variant": variant,
        "info": {k: body[k] for k in ("kind", "n_micro", "layout", "rules")
                 if k in body},
        "roofline": rl,
        "t_step_overlap_s": t_step,
        "roofline_frac": rl["compute_s"] / t_step if t_step else 0.0,
        "memory_s_with_kernel": body["memory_s_with_kernel"],
        "roofline_frac_with_kernel": (rl["compute_s"] / t_step_k
                                      if t_step_k else 0.0),
        "hbm_gb": body["hbm_per_device_gb"],
        "hbm_adjusted_gb": body["hbm_adjusted_gb"],
        "peak_gb": body["peak_gb"],
        "fits": body["fits"],
        "collectives": body["analysis"]["collectives"],
        "wall_s": time.time() - t0,
    }
    out = pathlib.Path(out_dir or RESULTS)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch}__{shape_name}__{tag}.json").write_text(
        json.dumps(rec, indent=2, default=float))
    print(f"[{tag}] {arch}/{shape_name}: compute={rl['compute_s']:.2f}s "
          f"memory={rl['memory_s']:.2f}s "
          f"collective={rl['collective_s']:.2f}s "
          f"dom={rl['dominant']} frac={rec['roofline_frac']:.3f} "
          f"hbm={rec['hbm_gb']:.1f}GiB fits={rec['fits']} "
          f"useful={rl['useful_ratio']:.2f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    run_variant(args.arch, args.shape, parse_variant(args.variant), args.tag,
                args.mesh, args.out_dir)


if __name__ == "__main__":
    main()
