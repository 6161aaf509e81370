"""Per-cell profile: the top contributors of one dry-run cell — the
modules by FLOPs, the ops by bytes with their loop multipliers, the
collectives by bytes and the largest live tensors at the peak (the
reference's ``repro.perf.diagnose``, read from the op counter instead of
HLO text). Device-free, as the dry-run is.

    PYTHONPATH=src python -m repro_torch.perf.diagnose --arch granite-20b \\
        --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse

from repro_torch.perf.op_cost import OpCounter, ring_bytes


def report(counter: OpCounter, top: int = 15) -> str:
    """The text report of a counter that ran a cell."""
    coll_rows = sorted(
        ((ring_bytes(op, b, g) * n, op, g, crosses, n, b)
         for (op, b, g, crosses), n in counter.collectives.items()),
        reverse=True)
    lines = [f"== totals: flops={counter.flops:.3e} "
             f"bytes={counter.bytes:.3e} "
             f"collective_bytes={sum(r[0] for r in coll_rows):.3e} "
             f"peak_live={counter.peak_bytes / 1e9:.2f}GB"]
    lines.append("-- top collectives (link bytes x count):")
    for b, op, g, crosses, n, res in coll_rows[:top]:
        lines.append(f"  {b:10.3e}  {op:<14} g={g:<4} x{n:<6.0f} "
                     f"{'DCN' if crosses else 'ici'}  result {res:.3e} B")
    lines.append("-- top modules by flops (site: flops, bytes):")
    for site, (fl, by) in sorted(counter.by_site.items(),
                                 key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"  {fl:10.3e}  {by:10.3e}  {site}")
    lines.append("-- top ops by bytes (op x loop multiplier: bytes, flops, "
                 "calls):")
    for (op, mult), (fl, by, calls) in sorted(
            counter.by_op.items(), key=lambda kv: -kv[1][1])[:top]:
        lines.append(f"  {by:10.3e}  {fl:10.3e}  {op:<24} x{mult:<6g} "
                     f"{calls} calls")
    lines.append("-- largest live tensors at the peak:")
    for n, shape, dtype, site in counter.peak_top[:top]:
        lines.append(f"  {n / 1e9:8.3f} GB  {dtype:<9} {list(shape)}  {site}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
    rec, counter = analyze_cell(args.arch, args.shape, mesh)
    mem = rec["analysis"]["memory"]
    print(f"argument {mem['argument_bytes'] / 1e9:.2f} GB, temp "
          f"{mem['temp_bytes'] / 1e9:.2f} GB, fits {rec['fits']}")
    print(report(counter, args.top))


if __name__ == "__main__":
    main()
