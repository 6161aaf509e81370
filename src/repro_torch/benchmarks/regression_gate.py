"""Cross-run bench regression gate (the reference's
``benchmarks/regression_gate.py``: standard library only, the same CLI and
rules; the port's bench rows and replay reports use the same fields). The
reference's CI workflow runs the reference's gate; this copy is not wired
into it. One departure: a replay report's ``per_request_j`` is a list of
(req_id, J) pairs (``launch.replay --json`` writes it so in both
packages), which the reference's drift check subtracts as numbers and
raises TypeError on; here each request's joules are held to the same
1e-6 J and the request ids must match.

Diffs the current run's ``--json`` bench rows against the previous run's
uploaded artifact and fails (exit 1) on:

- a relative slowdown beyond ``--threshold`` (default 15%) on any row's
  ``us_per_call``, or
- ANY increase in a row's ``compiles`` field — compile counts are a serving
  invariant (prefill executables are bounded by the bucket count), so a
  single new executable means some change reintroduced a retrace and is
  silently burning watts on XLA compilation instead of tokens, or
- ANY decrease in a row's ``hit_rate`` field — the prefix-cache hit rate on
  the shared-prefix workload is deterministic, so a drop means a sharing
  regression (trie matching, block refcounts, admission) is silently
  recomputing prefill work the cache used to serve for free, or
- ANY increase in a row's ``findings`` field — the port's linter
  (``python -m repro_torch.analysis --gate-json``) emits one row per rule
  with its non-suppressed finding count; an increase means a new DLK
  violation landed without a pragma or a fix, or
- ANY drift in a replay-report row (``launch.replay --json``: rows carrying
  ``attributed_j``) — replay is a pure function of (trace bytes, workload,
  policy) and the CI trace is recorded from seeded sources, so energies are
  bit-stable across runs and counts (completed/shed/tokens) are exact; any
  change means an admission-policy or attribution regression, or
- a ``budget`` row exceeding its ceiling: a row shaped
  ``{"value": v, "budget": b}`` fails whenever ``v > b``, *including on the
  first run with no previous artifact* — absolute acceptance bars (e.g. the
  serving bench's span-emission overhead, <5% decode tokens/s) gate
  themselves rather than only gating drift.

``--history FILE`` appends one record per gated artifact (rows + failure
strings, plus ``--run-id`` when given) to a JSON list that CI carries
forward as an artifact — the cross-run trajectory is inspectable instead
of only the last pairwise diff.

Rows carrying a ``compiles`` field are *only* gated on the compile count:
their wall time is cold-compile-dominated by design, which swings well past
any reasonable threshold across differently-provisioned CI runners with
zero code change. The deterministic count is the signal; the time is noise.

Rows present only in one file are reported but never fail the gate (new
benches must be able to land; deleted benches must not wedge CI forever).

    python -m repro_torch.benchmarks.regression_gate PREV.json CURRENT.json
    python -m repro_torch.benchmarks.regression_gate --prev-dir prev/ \
        --cur-dir . \
        [--threshold 0.15] [--pattern "BENCH_*.json"]

Directory mode pairs files by basename, so one invocation gates every
artifact the CI perf-trajectory job uploads (serving, energy platform,
scheduler, roofline).
"""
import argparse
import glob
import json
import os
import sys

# rows cheaper than this are timer noise on shared CI runners; the compile
# gate still applies to them, only the slowdown check is skipped
MIN_GATED_US = 50.0


def load_rows(path):
    with open(path) as f:
        return json.load(f)


def diff_rows(name, prev, cur, threshold):
    """Compare one artifact's row dicts; returns a list of failure strings."""
    failures = []
    common = sorted(set(prev) & set(cur))
    for row in common:
        p, c = prev[row], cur[row]
        compile_row = "compiles" in p or "compiles" in c
        p_us, c_us = p.get("us_per_call", 0.0), c.get("us_per_call", 0.0)
        if (not compile_row and p_us >= MIN_GATED_US
                and c_us > p_us * (1.0 + threshold)):
            failures.append(
                f"{name}:{row}: {p_us:.1f}us -> {c_us:.1f}us "
                f"(+{(c_us / p_us - 1.0) * 100:.1f}% > "
                f"{threshold * 100:.0f}% threshold)")
        p_comp, c_comp = p.get("compiles"), c.get("compiles")
        if p_comp is not None and c_comp is not None and c_comp > p_comp:
            failures.append(
                f"{name}:{row}: compile count regressed "
                f"{p_comp} -> {c_comp} (any increase fails: a retrace "
                f"was reintroduced)")
        p_hit, c_hit = p.get("hit_rate"), c.get("hit_rate")
        if p_hit is not None and c_hit is not None and c_hit < p_hit - 1e-6:
            failures.append(
                f"{name}:{row}: prefix-cache hit rate regressed "
                f"{p_hit:.3f} -> {c_hit:.3f} (any decrease fails: a "
                f"sharing regression is recomputing cached prefill work)")
        p_find, c_find = p.get("findings"), c.get("findings")
        if p_find is not None and c_find is not None and c_find > p_find:
            failures.append(
                f"{name}:{row}: static-analysis findings regressed "
                f"{p_find} -> {c_find} (any increase fails: a new "
                f"dalek-lint violation landed without a fix or pragma)")
        # replay-report rows (launch.replay --json) are bit-deterministic:
        # energies must match to float tolerance, counts exactly
        if "attributed_j" in p and "attributed_j" in c:
            for fld in ("energy_j", "attributed_j", "per_request_j"):
                pv, cv = p.get(fld), c.get(fld)
                if pv is None or cv is None:
                    continue
                if isinstance(pv, list):
                    drift = _request_drift(pv, cv)
                    if drift > 1e-6:
                        failures.append(
                            f"{name}:{row}: replay {fld} drifted by "
                            f"{drift:.6f} J on a request (replay is "
                            f"deterministic; any drift is an "
                            f"attribution/policy regression)")
                elif abs(cv - pv) > 1e-6:
                    failures.append(
                        f"{name}:{row}: replay {fld} drifted "
                        f"{pv:.6f} -> {cv:.6f} J (replay is deterministic; "
                        f"any drift is an attribution/policy regression)")
            for fld in ("completed", "shed", "tokens"):
                pv, cv = p.get(fld), c.get(fld)
                if pv is not None and cv is not None and cv != pv:
                    failures.append(
                        f"{name}:{row}: replay {fld} changed {pv} -> {cv} "
                        f"(admission decisions on a recorded trace must be "
                        f"reproducible)")
    for row in sorted(set(cur) - set(prev)):
        print(f"  [new row, not gated] {name}:{row}")
    for row in sorted(set(prev) - set(cur)):
        print(f"  [row disappeared, not gated] {name}:{row}")
    return failures


def _request_drift(prev, cur):
    """The largest |J| change of a request between two ``per_request_j``
    lists of (req_id, J) pairs; infinite when their requests differ."""
    if [r for r, _ in prev] != [r for r, _ in cur]:
        return float("inf")
    return max((abs(c - p) for (_, p), (_, c) in zip(prev, cur)),
               default=0.0)


def check_budgets(name, rows):
    """Absolute ceilings: rows shaped {"value": v, "budget": b} fail on
    v > b. Applied to every *current* artifact — paired or not — so a new
    budget row gates itself from its first run."""
    failures = []
    for row in sorted(rows):
        r = rows[row]
        if not isinstance(r, dict) or "budget" not in r or "value" not in r:
            continue
        v, b = r["value"], r["budget"]
        if v > b:
            failures.append(
                f"{name}:{row}: value {v:.4f} exceeds budget {b:.4f} "
                f"(absolute ceiling, gated even without a previous artifact)")
        else:
            print(f"  [budget ok] {name}:{row}: {v:.4f} <= {b:.4f}")
    return failures


def append_history(path, run_id, artifacts, failures):
    """Append one record per gate invocation to a JSON-list history file."""
    history = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                history = json.load(f)
            if not isinstance(history, list):
                history = []
        except (json.JSONDecodeError, OSError):
            history = []
    history.append({
        "run_id": run_id,
        "passed": not failures,
        "failures": failures,
        "artifacts": artifacts,
    })
    with open(path, "w") as f:
        json.dump(history, f, indent=1, sort_keys=True)
    print(f"gate history -> {path} ({len(history)} record(s))")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="*",
                    help="PREV.json CURRENT.json (file mode)")
    ap.add_argument("--prev-dir", default=None)
    ap.add_argument("--cur-dir", default=None)
    ap.add_argument("--pattern", default="BENCH_*.json")
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="max relative us_per_call slowdown (0.15 = 15%%)")
    ap.add_argument("--history", default=None,
                    help="JSON file to append this run's gate record to "
                         "(rows + failures); CI carries it forward as an "
                         "artifact so the trajectory is inspectable")
    ap.add_argument("--run-id", default="",
                    help="opaque id stamped into --history records "
                         "(e.g. $GITHUB_RUN_ID)")
    args = ap.parse_args(argv)

    pairs = []       # artifacts with a previous counterpart
    unpaired = []    # current-only artifacts (still budget-checked)
    if args.prev_dir and args.cur_dir:
        cur_files = sorted(glob.glob(os.path.join(args.cur_dir, args.pattern)))
        if not cur_files:
            print(f"no artifacts matching {args.pattern} in {args.cur_dir}")
            return 1
        for cur in cur_files:
            base = os.path.basename(cur)
            prev = os.path.join(args.prev_dir, base)
            if os.path.exists(prev):
                pairs.append((base, prev, cur))
            else:
                print(f"  [no previous artifact, drift not gated] {base}")
                unpaired.append((base, cur))
    elif len(args.files) == 2:
        pairs.append((os.path.basename(args.files[1]), *args.files))
    else:
        ap.error("pass PREV.json CURRENT.json or --prev-dir/--cur-dir")

    failures = []
    artifacts = {}
    for name, prev, cur in pairs:
        print(f"gate: {prev} vs {cur}")
        cur_rows = load_rows(cur)
        artifacts[name] = cur_rows
        failures += diff_rows(name, load_rows(prev), cur_rows, args.threshold)
        failures += check_budgets(name, cur_rows)
    for name, cur in unpaired:
        cur_rows = load_rows(cur)
        artifacts[name] = cur_rows
        failures += check_budgets(name, cur_rows)

    if args.history:
        append_history(args.history, args.run_id, artifacts, failures)

    if failures:
        print(f"\nREGRESSION GATE FAILED ({len(failures)}):")
        for f in failures:
            print(f"  {f}")
        return 1
    print(f"\nregression gate passed ({len(pairs)} paired + "
          f"{len(unpaired)} budget-only artifact(s), "
          f"threshold {args.threshold * 100:.0f}%, compile counts pinned)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
