"""The port's flash attention against the reference.

On the CPU the wrapper runs the kernel's plain version; it is held against
the Pallas TPU kernel (interpret mode) and its oracle over the sweeps of
``tests/test_kernels.py``, and — in the serving mode the kernel adds
(q_offset, GQA by head index, ragged S and T) — against
``repro.models.common.blocked_attention`` with the reference's
``arange + offset`` query positions and ``2**30`` invalid-tail keys.
Tolerances: 1e-5 (rtol and atol) in f32, 2e-2 in bf16 (the output is
rounded to bf16 once in each framework). The CUDA kernel itself is held
against the plain version on the card (``cuda`` marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as fa_kernel
from repro.kernels.flash_attention import ref as fa_ref
from repro.models import common as jcommon
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import common as tcommon

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(rng, shapes, dtype):
    """The same values in both frameworks: numpy f32 -> dtype once."""
    out = []
    for shape in shapes:
        a = jnp.asarray(rng.normal(size=shape).astype(np.float32), JDT[dtype])
        t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[dtype])
        out.append((a, t))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("b,h,s,t,d", [
    (1, 2, 128, 128, 64),
    (2, 1, 256, 256, 128),
    (1, 2, 128, 256, 64),   # cross-length (q shorter than kv)
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_shapes_match_pallas_and_oracle(b, h, s, t, d, causal, dtype):
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        rng, [(b, h, s, d), (b, h, t, d), (b, h, t, d)], dtype)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (b, h, s, d)
    pallas = fa_kernel.flash_attention(qj, kj, vj, causal=causal,
                                       interpret=True)
    oracle = fa_ref.attention(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("window", [32, 128])
def test_flash_window_matches_pallas(window):
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        rng, [(1, 2, 256, 64)] * 3, "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    pallas = fa_kernel.flash_attention(qj, kj, vj, causal=True, window=window,
                                       block_q=64, block_kv=64,
                                       interpret=True)
    oracle = fa_ref.attention(qj, kj, vj, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL["float32"])


@pytest.mark.parametrize("bq,bkv", [(32, 128), (64, 64), (128, 32)])
def test_flash_matches_every_pallas_block_shape(bq, bkv):
    """The Pallas kernel's output does not depend on its block shape; the
    port agrees with each decomposition."""
    rng = np.random.default_rng(6 + bq)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        rng, [(1, 1, 128, 64)] * 3, "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True)
    pallas = fa_kernel.flash_attention(qj, kj, vj, causal=True, block_q=bq,
                                       block_kv=bkv, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL["float32"])


# (B, S, T, H, Hkv, D, q_offset): ragged S and T, GQA ratios 1..8, offsets
# from a cold prefill (0) to a prefix hit ending exactly at T
SERVING_CASES = [
    (1, 23, 40, 4, 1, 16, 17),
    (2, 8, 48, 8, 2, 32, 32),
    (1, 37, 64, 4, 4, 64, 0),
    (1, 16, 48, 8, 1, 16, 32),
    (2, 5, 24, 6, 3, 128, 3),
]


@pytest.mark.parametrize("b,s,t,h,hkv,d,off", SERVING_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offset_gqa_ragged_matches_blocked_attention(b, s, t, h, hkv, d, off,
                                                     dtype):
    rng = np.random.default_rng(s * 100 + t)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        rng, [(b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)], dtype)
    q_pos = jnp.arange(s) + off
    k_pos = jnp.arange(t)
    k_pos = jnp.where(k_pos < off + s, k_pos, 2**30)   # invalid cache tail
    want = jcommon.blocked_attention(
        qj, jcommon._repeat_kv(kj, h), jcommon._repeat_kv(vj, h), q_pos,
        k_pos, causal=True, window=None, is_global=True, q_block=8)
    got = tcommon.blocked_attention(qt, kt, vt, q_offset=off)
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    # the wrapper in the kernel's own [B,H,S,D] layout agrees too
    direct = ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                 vt.transpose(1, 2), q_offset=off)
    np.testing.assert_array_equal(_np(direct.transpose(1, 2)), _np(got))


def test_cpu_path_is_the_plain_version_and_not_counted():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in [(1, 4, 9, 16), (1, 2, 12, 16), (1, 2, 12, 16)])
    before = ops.launches
    got = ops.flash_attention(q, k, v, q_offset=3)
    want = ref.attention(q, k, v, q_offset=3)
    assert torch.equal(got, want)
    assert ops.launches == before


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "gqa", "offset",
                                 "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "dtype":
        q, k = q.double(), k.double()
    elif bad == "head_dim":
        q, k = torch.zeros(1, 4, 8, 24), torch.zeros(1, 2, 8, 24)
    elif bad == "gqa":
        k = torch.zeros(1, 3, 8, 16)
    elif bad == "offset":
        kw = {"q_offset": -1}
    elif bad == "device":
        # neither the host nor a CUDA card: no plain-version fallback
        q, k = q.to("meta"), k.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, k, **kw)
