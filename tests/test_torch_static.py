"""The port's static engine, contiguous backend, ``greedy`` argument and
power capping against the reference, on granite-20b's smoke config in f32
with bridged weights and the same ``DeviceSpec`` values on both sides.

The engines agree on what a run decides — completions, sheds, finish
reasons, token counts, compile counts, the DVFS operating point and the
tokens themselves. Joules come from each run's own wall clock, so they are
compared only inside one run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.models import build_model as jbuild
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.queue import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.hw import H100_SXM
from repro_torch.models import build_model as tbuild
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.step import make_decode_step, make_paged_decode_step
from torch_weights import both_trees

MAX_SEQ = 48
JDEV = jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_smoke("granite-20b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("granite-20b").replace(dtype="float32")
    jm = jbuild(jcfg, q_block=8)
    jp, tp = both_trees(tcfg, 0)
    return jm, jp, tbuild(tcfg), tp


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lengths]


def _pair(prompts, max_new):
    return ([JRequest(i, p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)],
            [Request(i, p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)])


@pytest.mark.parametrize("lengths,buckets", [([3, 11, 7, 9], "auto"),
                                             ([6, 9], "auto"),
                                             ([3, 11, 7], "off")])
def test_static_engine_matches_reference(models, lengths, buckets):
    """One static batch (left-padded to its longest prompt, right-padded to
    the bucket edge, filler rows where fewer requests than the batch),
    then a second batch through the same engine."""
    jm, jp, tm, tp = models
    prompts = _prompts(lengths, 8)
    jreqs, treqs = _pair(prompts, 5)
    je = JServeEngine(jm, jp, batch_size=4, max_seq=MAX_SEQ, dev=JDEV,
                      prefill_buckets=buckets)
    te = ServeEngine(tm, tp, batch_size=4, max_seq=MAX_SEQ,
                     prefill_buckets=buckets)
    for _ in range(2):
        jreqs, treqs = _pair(prompts, 5)
        jstats, tstats = je.serve(jreqs), te.serve(treqs)
        for key in ("decode_steps", "tokens_decoded", "prompt_tokens",
                    "prefill_compiles", "decode_compiles", "compiles"):
            assert tstats[key] == jstats[key], key
        for a, b in zip(treqs, jreqs):
            assert a.finish_reason == b.finish_reason == "length"
            assert a.output == b.output, f"req {a.req_id}"
    assert tstats["decode_compiles"] == 1 and tstats["prefill_compiles"] == 1
    assert set(tstats["energy_by_tag"]) == set(jstats["energy_by_tag"])


def test_static_engine_bucketed_matches_exact(models):
    _, _, tm, tp = models
    prompts = _prompts([3, 11], 8)                 # batch max 11 -> bucket 16
    a = [Request(i, p.copy(), max_new_tokens=5) for i, p in enumerate(prompts)]
    b = [Request(i, p.copy(), max_new_tokens=5) for i, p in enumerate(prompts)]
    ServeEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ, telemetry=False,
                prefill_buckets="off").serve(a)
    st = ServeEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ, telemetry=False,
                     prefill_buckets="auto").serve(b)
    for ra, rb in zip(a, b):
        assert ra.output == rb.output
    assert st["prompt_tokens"] == 14


def test_static_filler_rows_stay_out_of_attribution(models):
    """Fewer requests than batch_size: filler rows decode as dead weight but
    contribute nothing to throughput stats or per-request joules."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, batch_size=4, max_seq=MAX_SEQ)
    reqs = [Request(i, p, max_new_tokens=4)
            for i, p in enumerate(_prompts([6, 9], 10))]
    stats = eng.serve(reqs)
    assert stats["prompt_tokens"] == 15
    parts = sum(r.energy_j for r in reqs)
    assert stats["energy_j"] > 0
    assert abs(stats["energy_j"] - parts) <= 1e-6 + 0.01 * stats["energy_j"]
    assert eng.stats.totals["decode"] == 2 * stats["decode_steps"]
    assert eng.stats.totals["prefill"] == 15


def test_static_engine_refuses_an_oversized_batch(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ, telemetry=False)
    reqs = [Request(i, p, max_new_tokens=2)
            for i, p in enumerate(_prompts([4, 4, 4], 1))]
    with pytest.raises(ValueError, match="static batch"):
        eng.serve(reqs)
    with pytest.raises(ValueError, match="static batch"):
        eng.serve([])


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("kv_block_size", ["auto", "off"])
def test_contiguous_and_paged_match_reference(models, greedy,
                                              kv_block_size):
    """The continuous engine on the paged pool and on contiguous rows
    (paging off), with ``greedy`` either way: both backends, both settings,
    the reference's tokens and decisions (the reference samples only when
    a key is passed, which its engines never do)."""
    jm, jp, tm, tp = models
    prompts = _prompts([9, 20, 4, 30, 14], 11)
    jreqs, treqs = _pair(prompts, 6)
    jstats = JEngine(jm, jp, batch_size=3, max_seq=MAX_SEQ, dev=JDEV,
                     greedy=greedy, kv_block_size=kv_block_size).serve(jreqs)
    tstats = ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ,
                              greedy=greedy,
                              kv_block_size=kv_block_size).serve(treqs)
    assert tstats["adapter"] == ("paged-kv" if kv_block_size == "auto"
                                 else "contiguous")
    for key in ("completed", "tokens_decoded", "prefills", "decode_steps",
                "slots_recycled", "peak_active", "prefill_compiles",
                "decode_compiles", "kv_block_size", "adapter"):
        assert tstats[key] == jstats[key], key
    for a, b in zip(treqs, jreqs):
        assert a.finish_reason == b.finish_reason
        assert a.output == b.output, f"req {a.req_id}"


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_flag_changes_no_decode_step(models, paged):
    """Both decode step factories build the same step under ``greedy=False``
    as under ``greedy=True``: equal tokens, logits and caches from the same
    cache contents, so the flag cannot start to mean something unseen."""
    _, _, tm, tp = models
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, 512, (2, 1)).astype(np.int32))
    pos = torch.tensor([5, 13])
    out = {}
    for greedy in (True, False):
        g = torch.Generator().manual_seed(0)
        if paged:
            # 8 blocks of 8 positions; row b reads blocks 4b .. 4b + 3
            cache = tuple(torch.randn(c.shape, generator=g) for c in
                          tm.init_cache(8, 8, dtype=torch.float32,
                                        device="cpu"))
            tables = torch.arange(8).reshape(2, 4)
            tok, logits, cache = make_paged_decode_step(tm, greedy)(
                tp, tokens, pos, tables, cache)
        else:
            cache = tuple(torch.randn(c.shape, generator=g) for c in
                          tm.init_cache(2, 32, dtype=torch.float32,
                                        device="cpu"))
            tok, logits, cache = make_decode_step(tm, greedy)(
                tp, tokens, pos, cache)
        out[greedy] = (tok, logits, cache)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for a, b in zip(out[True][2], out[False][2]):
        assert torch.equal(a, b)


def test_contiguous_equals_paged_inside_the_port(models):
    _, _, tm, tp = models
    prompts = _prompts([9, 20, 4, 30, 14, 25], 13)
    runs = {}
    for kv in ("auto", "off"):
        reqs = [Request(i, p.copy(), max_new_tokens=7)
                for i, p in enumerate(prompts)]
        ContinuousEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ,
                         telemetry=False, kv_block_size=kv,
                         prefix_cache=False).serve(reqs)
        runs[kv] = [r.output for r in reqs]
    assert runs["auto"] == runs["off"]


@pytest.mark.parametrize("cap", [60.0, 100.0, 150.0, 250.0, 290.0, 300.0,
                                 400.0])
def test_power_cap_matches_reference(models, cap):
    """Six requests under a node power cap, ``H100_SXM`` values on both
    sides: the DVFS point, the admitted concurrency and sheds, the stats,
    tokens and finish reasons are the reference's at every cap. At 60 W
    the clock drops and every request is shed, up to 290 W every request
    is shed at the top clock, from 300 W all are served."""
    jm, jp, tm, tp = models
    prompts = _prompts([12, 5, 20, 9, 16, 7], 14)
    jreqs, treqs = _pair(prompts, 6)
    jstats = JEngine(jm, jp, batch_size=4, max_seq=MAX_SEQ, dev=JDEV,
                     power_cap_w=cap).serve(jreqs)
    tstats = ContinuousEngine(tm, tp, batch_size=4, max_seq=MAX_SEQ,
                              power_cap_w=cap).serve(treqs)
    for key in ("completed", "shed", "tokens_decoded", "prefills",
                "decode_steps", "slots_recycled", "peak_active",
                "dvfs_f_ghz", "prefill_compiles", "decode_compiles"):
        assert tstats[key] == jstats[key], (cap, key)
    for a, b in zip(treqs, jreqs):
        assert a.finish_reason == b.finish_reason
        assert a.output == b.output, f"req {a.req_id}"
