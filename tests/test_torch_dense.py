"""qwen3-32b (GQA with qk_norm) and deepseek-coder-33b (plain GQA) in the
port against the reference, on their smoke configs in f32 with bridged
weights: forward logits, prefill into a flat cache (bucketed and after a
cached prefix), decode at per-row positions, and the continuous engine on
the paged KV pool.

Every comparison holds fp32 numerics to atol 1e-4 (rtol 1e-4), as the
granite parity tests do; token streams are greedy.
"""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.models import build_model as tbuild
from repro_torch.serve.engine import ContinuousEngine, Request
from torch_weights import both_trees

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHES = ["qwen3-32b", "deepseek-coder-33b"]


@pytest.fixture(scope="module", params=ARCHES)
def models(request):
    jcfg = jconfigs.get_smoke(request.param).replace(dtype="float32")
    tcfg = tconfigs.get_smoke(request.param).replace(dtype="float32")
    jm = jbuild(jcfg, q_block=8)
    jp, tp = both_trees(tcfg, 2)
    return jcfg, jm, jp, tcfg, tbuild(tcfg), tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_config_and_param_tree(models):
    jcfg, _, jp, tcfg, tm, tp = models
    name = jcfg.name.removesuffix("-smoke")
    assert tconfigs.get(name) == tconfigs.base.ModelConfig(
        **dataclasses.asdict(jconfigs.get(name)))
    jshapes = jax.tree.map(lambda a: a.shape, jax.tree.map(np.asarray, jp))
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert jshapes == jax.tree.map(
        lambda t: tuple(t.shape), own,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert ("q_norm" in own["layers"]["attn"]) == tcfg.qk_norm


def test_forward_logits(models):
    _, jm, jp, _, tm, tp = models
    toks = np.random.default_rng(5).integers(0, 512, (2, 13)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("true_len,start_pos", [(None, None), (9, None),
                                                (5, 16)])
def test_prefill_matches(models, true_len, start_pos):
    jcfg, jm, jp, _, tm, tp = models
    rng = np.random.default_rng(6)
    jcache = jm.init_cache(1, 48, jnp.float32)
    tcache = tm.init_cache(1, 48, torch.float32, device="cpu")
    if start_pos is not None:
        shape = (jcfg.num_layers, 1, start_pos, jcfg.num_kv_heads,
                 jcfg.head_dim)
        prefix = rng.normal(size=shape).astype(np.float32)
        jcache = tuple(c.at[:, :, :start_pos].set(prefix) for c in jcache)
        for c in tcache:
            c[:, :, :start_pos] = _t(prefix)
    toks = rng.integers(0, 512, (1, 16)).astype(np.int32)
    kw = {}
    if true_len is not None:
        kw["true_len"] = jnp.int32(true_len)
    if start_pos is not None:
        kw["start_pos"] = jnp.int32(start_pos)
    want, wcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache, **kw)
    got, gcache = tm.prefill(tp, {"tokens": _t(toks).long()}, tcache,
                             true_len=true_len, start_pos=start_pos)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b in zip(gcache, wcache):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_teacher_forced_decode_per_row_positions(models):
    jcfg, jm, jp, _, tm, tp = models
    rng = np.random.default_rng(8)
    b, t = 3, 32
    shape = (jcfg.num_layers, b, t, jcfg.num_kv_heads, jcfg.head_dim)
    init = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jcache = tuple(map(jnp.asarray, init))
    tcache = tuple(map(_t, init))
    pos = np.array([5, 17, 0], np.int32)
    toks = rng.integers(0, 512, (4, b, 1)).astype(np.int32)
    for step in range(4):
        p = pos + step
        want, jcache = jm.decode_step(jp, jnp.asarray(toks[step]),
                                      jnp.asarray(p), jcache)
        got, tcache = tm.decode_step(tp, _t(toks[step]).long(), _t(p),
                                     tcache)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b_ in zip(tcache, jcache):
        np.testing.assert_allclose(_np(a), _np(b_), **TOL)


def test_paged_engine_matches_reference(models):
    """Five requests, four sharing a 16-token prefix, on the paged pool
    with prefix sharing: the port's engine against the reference's."""
    _, jm, jp, _, tm, tp = models
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 512, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, 2 + 3 * i)
                               .astype(np.int32)]) for i in range(4)]
    prompts.append(rng.integers(0, 512, 11).astype(np.int32))
    jreqs = [JRequest(i, p.copy(), max_new_tokens=5)
             for i, p in enumerate(prompts)]
    treqs = [Request(i, p.copy(), max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jdev = jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))
    jstats = JEngine(jm, jp, batch_size=2, max_seq=48, dev=jdev).serve(jreqs)
    tstats = ContinuousEngine(tm, tp, batch_size=2, max_seq=48).serve(treqs)
    for key in ("completed", "tokens_decoded", "prefills",
                "prefill_tokens_computed", "decode_steps", "peak_active",
                "prefill_compiles", "decode_compiles", "kv_block_size",
                "adapter", "prefix_cache"):
        assert tstats[key] == jstats[key], key
    assert tstats["prefix_cache"]["hits"] > 0
    for a, b in zip(treqs, jreqs):
        assert a.finish_reason == b.finish_reason
        assert a.cached_prompt_tokens == b.cached_prompt_tokens
        assert a.output == b.output, f"req {a.req_id}"
