"""The port's continuous engine: inside the port (prefix hit == cold
prefill, copy-on-write isolation, the joule partition, the CLI) and against
the reference engine on the same requests, with the same weights on both
sides (drawn from a numpy seed: ``torch_weights``), both in f32 and with
the same ``DeviceSpec`` values.

The engines agree on what a run decides — completions, sheds, finish
reasons, token counts, signature/compile counts and the tokens themselves.
Joules come from each run's own wall clock, so they are compared only
inside one run: per-request joules partition the slot-tag energy to 1e-6 J.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.models import build_model as jbuild
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.queue import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.hw import H100_SXM
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.serve.engine import ContinuousEngine, Request
from torch_weights import both_trees

MAX_SEQ = 48


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_smoke("granite-20b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("granite-20b").replace(dtype="float32")
    jm = jbuild(jcfg, q_block=8)
    jp, tp = both_trees(tcfg, 0)
    return jcfg, jm, jp, tcfg, tbuild(tcfg), tp


def _shared_prefix_prompts(vocab, n, shared_len=16, seed=7):
    """n prompts sharing a ``shared_len``-token prefix, ragged tails."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    return [np.concatenate([shared, np.random.default_rng(100 + i).integers(
        0, vocab, 3 + 4 * i).astype(np.int32)]) for i in range(n)]


def _reqs(cls, prompts, max_new=6):
    return [cls(i, p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def both_runs(models):
    """One reference run and one port run of the same 6 requests."""
    _, jm, jp, _, tm, tp = models
    prompts = _shared_prefix_prompts(512, 6)
    jreqs, treqs = _reqs(JRequest, prompts), _reqs(Request, prompts)
    jdev = jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))
    jstats = JEngine(jm, jp, batch_size=4, max_seq=MAX_SEQ,
                     dev=jdev).serve(jreqs)
    eng = ContinuousEngine(tm, tp, batch_size=4, max_seq=MAX_SEQ)
    tstats = eng.serve(treqs)
    return jreqs, jstats, treqs, tstats, eng


def _margins(models, req, out, step):
    """The top-2 logit margin of each model where two outputs part: its
    forward over the prompt and the ``step`` tokens both emitted before.
    A margin near 0 on either side is a tie, not a port fault."""
    _, jm, jp, _, tm, tp = models
    toks = np.concatenate([req.prompt, np.asarray(out[:step], np.int32)])
    toks = toks[None].astype(np.int32)
    jl = np.asarray(jm.forward(jp, {"tokens": toks})[0])[0, -1]
    with torch.no_grad():
        tl = tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0][0, -1]
    top = [np.sort(np.asarray(x, np.float64))[-2:] for x in (jl, tl.numpy())]
    return {k: float(t[1] - t[0]) for k, t in zip(("reference", "port"),
                                                   top)}


def test_engine_matches_reference(models, both_runs):
    # the reference's pool-maintenance counts (zero_blocks, copy_block) are
    # left out: they jit module-level functions, whose executables another
    # test in the same process may already have compiled
    jreqs, jstats, treqs, tstats, _ = both_runs
    for key in ("completed", "shed", "tokens_decoded", "prefills",
                "prompt_tokens", "prefill_tokens_computed", "decode_steps",
                "slots_recycled", "peak_active", "prefill_compiles",
                "decode_compiles", "prefill_buckets", "kv_block_size",
                "adapter"):
        assert tstats[key] == jstats[key], key
    assert tstats["completed"] == 6 and tstats["shed"] == 0
    assert tstats["prefix_cache"] == jstats["prefix_cache"]
    assert tstats["prefix_cache"]["hits"] > 0
    for a, b in zip(treqs, jreqs):
        assert a.finish_reason == b.finish_reason
        assert a.cached_prompt_tokens == b.cached_prompt_tokens
        assert len(a.output) == len(b.output)
        if a.output != b.output:
            step = next(i for i, (x, y) in enumerate(zip(a.output, b.output))
                        if x != y)
            raise AssertionError(
                f"req {a.req_id}: token {step} is {a.output[step]} in the "
                f"port, {b.output[step]} in the reference; top-2 logit "
                f"margins there {_margins(models, a, a.output, step)}")


def test_joules_partition_slot_tag_energy(both_runs):
    _, _, treqs, tstats, eng = both_runs
    slot_tags = {eng.tel.slot_tag(i) for i in range(eng.batch_size)}
    slot_j = 0.0
    for blk in eng.tel.session.blocks():
        any_slot = np.zeros(blk.n, bool)
        for tag in slot_tags:
            any_slot |= blk.tag_mask(tag)
        # the block's own reduction (``SampleBlock.energy_j``: watts @ dt),
        # so that a session whose every sample holds a slot tag sums to
        # the report's total bit for bit, not to one ulp either side
        slot_j += float(blk.watts[any_slot] @ blk.dt[any_slot])
    parts = sum(r.energy_j for r in treqs)
    assert all(r.energy_j > 0.0 for r in treqs)
    assert parts == pytest.approx(slot_j, abs=1e-6)
    assert tstats["energy_j"] >= slot_j > 0.0


def _prefix_reqs(cfg, n, shared_len=24, tail_len=6, max_new=5, seed=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, shared_len).astype(np.int32)
    return [Request(i, np.concatenate([shared, np.random.default_rng(
        1000 + i).integers(0, cfg.vocab_size, tail_len).astype(np.int32)]),
        max_new_tokens=max_new) for i in range(n)]


def test_prefix_hit_matches_cold(models):
    _, _, _, tcfg, tm, tp = models
    warm, cold = _prefix_reqs(tcfg, 3), _prefix_reqs(tcfg, 3)
    sw = ContinuousEngine(tm, tp, batch_size=1, max_seq=MAX_SEQ,
                          telemetry=False).serve(warm)
    ContinuousEngine(tm, tp, batch_size=1, max_seq=MAX_SEQ, telemetry=False,
                     prefix_cache=False).serve(cold)
    assert [r.cached_prompt_tokens for r in warm] == [0, 16, 16]
    assert sw["prefix_cache"]["hits"] == 2
    for rw, rc in zip(warm, cold):
        assert rw.output == rc.output


def test_prefix_sharing_isolation(models):
    """Slots decoding concurrently off the same shared blocks, with the
    pool's copy-on-write backstop, emit what each request emits alone."""
    _, _, _, tcfg, tm, tp = models
    together = _prefix_reqs(tcfg, 3, max_new=6, seed=21)
    eng = ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ,
                           telemetry=False)
    eng.serve(together)
    for i in range(3):
        alone = _prefix_reqs(tcfg, 3, max_new=6, seed=21)[i]
        ContinuousEngine(tm, tp, batch_size=1, max_seq=MAX_SEQ,
                         telemetry=False, prefix_cache=False).serve([alone])
        assert together[i].output == alone.output


def test_copy_on_write_leaves_the_shared_block_intact(models):
    _, _, _, tcfg, tm, tp = models
    eng = ContinuousEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ,
                           telemetry=False)
    ad = eng.adapter
    ad.ensure_ready()
    src = ad.pages.alloc()
    for c in ad.caches:
        c[:, src] = torch.randn(c[:, src].shape, dtype=c.dtype)
    before = [c[:, src].clone() for c in ad.caches]
    ad.pages.map_shared(0, [src])                 # slot 0 shares block src
    state, s, dst = ad.pages.ensure_writable(0, 3, ad._alloc_block)
    assert state == "cow" and s == src
    ad.caches = ad._copy_block(ad.caches, s, dst)
    for c, b in zip(ad.caches, before):
        assert torch.equal(c[:, dst], b)          # the writer's copy
        c[:, dst] = 0                             # ... is its own
        assert torch.equal(c[:, src], b)          # the original survives


def test_cli_runs_to_the_end(capsys):
    stats = tserve.main(["--arch", "granite-20b", "--smoke", "--device",
                         "cpu", "--requests", "3", "--batch", "2",
                         "--prompt-len", "8", "--max-new", "3",
                         "--max-seq", "32"])
    out = capsys.readouterr().out
    assert stats["completed"] == 3 and stats["decode_compiles"] == 1
    assert "paged-kv" in out and "J/token" in out
