"""Roofline report: reads the port's dry-run records (build/dryrun/*) and
prints the three-term roofline per (arch x shape x mesh) and J/token from
the port's energy model on ``H100_SXM`` (the reference's
``benchmarks/bench_roofline.py``). ``--json PATH`` dumps the rows (empty
when no dry-run record exists). Device-free: it reads records.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_roofline \\
        [--json PATH]
"""
import argparse
import json
import pathlib

from repro_torch.benchmarks.common import BenchRows
from repro_torch.core import energy
from repro_torch.launch.dryrun import RESULTS

SHAPE_TOKENS = {"train_4k": 256 * 4096, "prefill_32k": 32 * 32768,
                "decode_32k": 128, "long_500k": 1}


def load(mesh="single", results=RESULTS):
    out = []
    d = pathlib.Path(results) / mesh
    if not d.exists():
        return out
    for f in sorted(d.glob("*.json")):
        rec = json.loads(f.read_text())
        if "roofline" in rec:
            out.append(rec)
    return out


def run(dev=None, json_path=None, results=RESULTS):
    """``dev`` is taken for ``benchmarks.run``'s signature: the report
    reads records and touches no device."""
    del dev
    rows = BenchRows()
    for mesh in ("single", "multi"):
        for rec in load(mesh, results):
            rl = rec["roofline"]
            terms = {"compute": rl["compute_s"], "memory": rl["memory_s"],
                     "collective": rl["collective_s"]}
            t_step = energy.step_time_s(terms)
            e_step = energy.step_energy_j(terms) * rec["n_chips"]
            jpt = e_step / SHAPE_TOKENS.get(rec["shape"], 1)
            frac = rl["compute_s"] / max(t_step, 1e-12)
            rows.record(f"roofline/{mesh}/{rec['arch']}/{rec['shape']}",
                        t_step,
                        f"dom={rl['dominant']};roofline_frac={frac:.3f};"
                        f"useful={rl['useful_ratio']:.2f};"
                        f"hbm={rec.get('hbm_per_device_gb', 0):.1f}GiB;"
                        f"fits={rec.get('fits')};J/tok={jpt:.4g}")
    rows.dump(json_path)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="dump rows as JSON")
    run(json_path=ap.parse_args().json)
