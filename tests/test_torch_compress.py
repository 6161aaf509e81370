"""The port's int8 compressed pod reduction against the reference's
(``repro.parallel.compress``), bit for bit.

The quantizer on ragged lengths; ``compressed_psum_pod`` and two error-fed
steps of ``compress_grads_over_pod`` at one rank on each package's
``make_host_mesh()``; and at 2 and 4 ``gloo`` ranks (spawned processes,
``tests/torch_dist_worker.py``) against the reference's formula composed
in this process from its own ``_quantize_blockwise``: the group's largest
scale, each rank's int8 values requantized against it, summed in int32,
dequantized and divided by the pod count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.launch.mesh import make_host_mesh as jmesh
from repro.parallel import compress as jc
from repro_torch.launch.mesh import make_host_mesh as tmesh
from repro_torch.parallel import compress as tc
from torch_dist_worker import one_rank, spawn

LENGTHS = [1, 5, 255, 256, 257, 511, 1000, 4099, 65536 + 17]


def _vector(n, seed):
    """Values over eleven decades, with an all-zero block where n allows
    (its scale is 1, not 0) and a few exact ties at .5 after scaling."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 10.0 ** rng.uniform(-8, 3, size=n)
    if n >= 768:
        x[256:512] = 0.0
        x[600] = 127.0
        x[601] = 63.5
    return x.astype(np.float32)


@pytest.mark.parametrize("n", LENGTHS)
def test_quantizer_matches_reference_bitwise(n):
    x = _vector(n, n)
    jq, js = jc._quantize_blockwise(jnp.asarray(x))
    tq, ts = tc._quantize_blockwise(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc._dequantize(tq, ts, n).numpy(),
                                  np.asarray(jc._dequantize(jq, js, n)))


@pytest.mark.parametrize("n", [1, 255, 256, 10**6, 10**9 + 7])
def test_compression_ratio_matches_reference(n):
    assert tc.compression_ratio(n) == jc.compression_ratio(n)


def _grad_tree(rng):
    """Leaves whose insertion order is not their sorted order: the
    concatenated vector follows ``jax.tree``'s sorted keys."""
    return {"w": rng.normal(size=(3, 100)).astype(np.float32),
            "b": {"z": rng.normal(size=(7, 61)).astype(np.float32) * 1e-3,
                  "a": rng.normal(size=(300,)).astype(np.float32)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_tree_equal(got, want):
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.numpy(), np.asarray(w)), want, got,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_one_rank_matches_reference_bitwise(tmp_path):
    """At one rank on each package's ``make_host_mesh()``: the psum over
    the pod axis, and two steps of the error-fed tree reduction (outputs
    and error states)."""
    x = _vector(4099, 7)
    mesh = jmesh()
    want = jax.shard_map(lambda v: jc.compressed_psum_pod(v), mesh=mesh,
                         in_specs=P(None), out_specs=P(None))(jnp.asarray(x))
    rng = np.random.default_rng(8)
    grads = [_grad_tree(rng) for _ in range(2)]
    with one_rank(tmp_path):
        got = tc.compressed_psum_pod(torch.from_numpy(x),
                                     tmesh().get_group("pod"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jerr = terr = None
        for g in grads:
            jred, jerr = jc.compress_grads_over_pod(
                jax.tree.map(jnp.asarray, g), mesh, jerr)
            tred, terr = tc.compress_grads_over_pod(_to_torch(g), tmesh(),
                                                    terr)
            _assert_tree_equal(tred, jred)
            _assert_tree_equal(terr, jerr)
    assert float(np.abs(np.asarray(jerr["w"])).max()) > 0


def _reference_psum(vectors):
    """The reference's reduction over ranks whose vectors differ, composed
    from its own quantizer."""
    n = vectors[0].shape[0]
    qs = [jc._quantize_blockwise(jnp.asarray(v)) for v in vectors]
    smax = qs[0][1]
    for _, s in qs[1:]:
        smax = jnp.maximum(smax, s)
    summed = sum(jnp.clip(jnp.round(q.astype(jnp.float32) * s / smax),
                          -127, 127).astype(jnp.int8).astype(jnp.int32)
                 for q, s in qs)
    return jc._dequantize(summed, smax, n) / jnp.float32(len(vectors))


def _sorted_vec(tree):
    return np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_reference_formula_bitwise(tmp_path, world):
    res = spawn("compress", world, tmp_path,
                {"pod": world, "seed": 3, "n": 4099})
    want = np.asarray(_reference_psum([r["flat"].numpy() for r in res]))
    errs = [None] * world
    for r in res:
        np.testing.assert_array_equal(r["psum"].numpy(), want)
    for step in range(2):
        vecs = []
        for i, r in enumerate(res):
            g = jax.tree.map(np.asarray, r[f"grads{step}"])
            v = _sorted_vec(g)
            if errs[i] is not None:
                v = v + errs[i]
            vecs.append(v.astype(np.float32))
        red = np.asarray(_reference_psum(vecs))
        for i, r in enumerate(res):
            q, s = jc._quantize_blockwise(jnp.asarray(vecs[i]))
            errs[i] = vecs[i] - np.asarray(jc._dequantize(q, s, len(vecs[i])))
            np.testing.assert_array_equal(
                _sorted_vec(jax.tree.map(np.asarray, r[f"red{step}"])), red)
            np.testing.assert_array_equal(
                _sorted_vec(jax.tree.map(np.asarray, r[f"err{step}"])),
                errs[i])
    # the ranks' gradients differ, so the mean is not any rank's own
    assert not np.array_equal(res[0]["flat"].numpy(), res[1]["flat"].numpy())
