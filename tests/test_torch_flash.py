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
import functools
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
    call = ops.flash_attention
    if bad == "dtype":
        q, k = q.double(), k.double()
    elif bad == "head_dim":
        q, k = torch.zeros(1, 4, 8, 24), torch.zeros(1, 2, 8, 24)
    elif bad == "gqa":
        k = torch.zeros(1, 3, 8, 16)
    elif bad == "offset":
        kw = {"q_offset": -1}
    elif bad == "device":
        # neither the host nor a CUDA card: no plain-version fallback, the
        # kernel's launch refuses it (flash_attention on meta tensors is
        # the custom op's fake: shapes only, nothing launched)
        q, k = q.to("meta"), k.to("meta")
        call = functools.partial(ops.launch, causal=True, window=None,
                                 q_offset=0, route="ffma", block_m=64)
    with pytest.raises((TypeError, ValueError)):
        call(q, k, k, **kw)


# --- the route and tile plan, and the wgmma route's packing, on the CPU ----

@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "ffma"), (torch.bfloat16, 16, "ffma"),
    (torch.float32, 128, "ffma"), (torch.float32, 64, "ffma"),
    (torch.float32, 32, "ffma"), (torch.float32, 16, "ffma"),
])
def test_plan_route_by_dtype_and_head_dim(dtype, d, route):
    """bf16 with D 64 or 128 takes the tensor cores; f32 stays true f32 on
    the FFMA kernel, and bf16 with D 16 or 32 (rows narrower than one
    128-byte TMA box) goes there too."""
    got, bm = ops.plan(1, 48, 1, 256, 512, d, dtype, 132)
    assert got == route and bm in ops.TILES[route]


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 128), (torch.bfloat16, 64), (torch.bfloat16, 32),
    (torch.float32, 128), (torch.float32, 16)])
def test_plan_sends_unaligned_tensors_to_ffma(dtype, d):
    """TMA reads only from 16-byte-aligned addresses: inputs that are not
    (an offset view) go to the FFMA kernel, which loads element by
    element, never to the wgmma kernel, which would refuse them."""
    assert ops.plan(1, 48, 1, 256, 512, d, dtype, 132,
                    aligned=False) == ("ffma", 64)


# the serve's prefill shapes on granite-20b (48 q heads, 1 kv head, D 128,
# T 512) on 132 SMs: (S, q_offset, blocks of 64 packed rows)
@pytest.mark.parametrize("s,off,n_blocks", [(64, 0, 48), (128, 128, 96),
                                            (256, 0, 192)])
def test_plan_tile_and_grid_at_the_serve_shapes(s, off, n_blocks):
    route, bm = ops.plan(1, 48, 1, s, 512, 128, torch.bfloat16, 132)
    assert (route, bm) == ("wgmma", 64)
    assert -(-48 * s // bm) == n_blocks


@pytest.mark.parametrize("b,h,hkv,s,t,d,sms", [
    (1, 48, 1, 512, 512, 128, 132), (1, 48, 1, 4096, 4096, 128, 132),
    (2, 48, 8, 100, 100, 64, 132), (1, 8, 8, 1, 9, 64, 132),
    (1, 48, 1, 256, 512, 128, 1), (1, 48, 1, 256, 512, 128, 1000)])
def test_plan_keeps_one_tile_on_each_route(b, h, hkv, s, t, d, sms):
    """The 128-row wgmma tile lost to the 64-row one at every serve shape
    (PERF.md), so no shape or SM count picks another tile."""
    assert ops.TILES == {"ffma": (64,), "wgmma": (64,)}
    assert ops.plan(b, h, hkv, s, t, d, torch.bfloat16, sms) == ("wgmma", 64)
    assert ops.plan(b, h, hkv, s, t, d, torch.float32, sms) == ("ffma", 64)


@pytest.mark.parametrize("b,h,hkv,s", [(1, 48, 1, 200), (2, 48, 8, 77),
                                       (1, 8, 2, 1)])
def test_gqa_packing_groups_the_heads_of_one_kv_head(b, h, hkv, s):
    """The wgmma route views contiguous q [B,H,S,D] as [B*Hkv, g*S, D]:
    packed row r of group b*Hkv + hk must be query head hk*g + r // s at
    position r % s, the head that reads kv head hk in ``ref.attention``."""
    g = h // hkv
    q = torch.arange(b * h * s * 2, dtype=torch.float32).view(b, h, s, 2)
    packed = q.view(b * hkv, g * s, 2)
    for grp in range(b * hkv):
        bb, hk = divmod(grp, hkv)
        for r in range(g * s):
            head = hk * g + r // s
            assert head // (h // hkv) == hk
            assert torch.equal(packed[grp, r], q[bb, head, r % s])


def test_cpu_path_counts_no_route():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               .bfloat16() for sh in [(1, 8, 9, 128), (1, 1, 12, 128),
                                      (1, 1, 12, 128)])
    before = dict(ops.route_launches), ops.launches
    got = ops.flash_attention(q, k, v, q_offset=3)
    assert torch.equal(got, ref.attention(q, k, v, q_offset=3))
    assert (dict(ops.route_launches), ops.launches) == before


@pytest.mark.parametrize("offset", [1, 3, 7])
def test_cpu_path_takes_offset_views(offset):
    """A contiguous view that starts off a 16-byte boundary is valid input:
    on the CPU it goes to the plain version like any other."""
    rng = np.random.default_rng(offset)
    n = 1 * 8 * 9 * 128
    buf = torch.from_numpy(rng.normal(size=offset + n).astype(np.float32))
    q = buf.bfloat16()[offset:].view(1, 8, 9, 128)
    k = torch.from_numpy(rng.normal(size=(1, 1, 12, 128)).astype(
        np.float32)).bfloat16()
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = dict(ops.route_launches), ops.launches
    got = ops.flash_attention(q, k, k, q_offset=3)
    assert torch.equal(got, ref.attention(q, k, k, q_offset=3))
    assert (dict(ops.route_launches), ops.launches) == before


@pytest.mark.parametrize("route,bm,err", [
    ("wgmma", 64, ValueError),      # a CPU tensor has no kernel
    ("wgmma", 32, ValueError),      # no such tile
    ("wgmma", 128, ValueError),
    ("ffma", 128, ValueError),
    ("mma", 64, ValueError),        # no such route
])
def test_launch_refuses_what_it_has_no_kernel_for(route, bm, err):
    q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(err):
        ops.launch(q, q[:, :1], q[:, :1], causal=True, window=None,
                   q_offset=0, route=route, block_m=bm)


# (S, T, window, q_offset, masks one key off): a window edge inside the
# rows, a window as long as the prompt (only the last row's window is cut
# by one key less), causal after a prefix
MARGIN_CASES = [
    (256, 256, 64, 0, [dict(window=63), dict(window=65),
                       dict(q_offset=1)]),
    (128, 128, 128, 0, [dict(window=127), dict(q_offset=1)]),
    (64, 192, None, 128, [dict(q_offset=127), dict(q_offset=129)]),
]


@pytest.mark.parametrize("s,t,window,off,wrong", MARGIN_CASES)
def test_mask_margin_tells_a_mask_one_key_off(s, t, window, off, wrong):
    """bf16 inputs: the plain version on the right mask, rounded to bf16,
    reads well under the 0.25 the card's checks allow; the plain version on
    a window or diagonal one key off reads about 1 or more."""
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               .bfloat16() for sh in [(1, 8, s, 64), (1, 4, t, 64),
                                      (1, 4, t, 64)])
    mask = dict(causal=True, window=window, q_offset=off)
    assert ref.mask_margin(ref.attention(q, k, v, **mask), q, k, v,
                           **mask) < 0.1
    for shift in wrong:
        bad = ref.attention(q, k, v, **{**mask, **shift})
        assert ref.mask_margin(bad, q, k, v, **mask) > 0.9, shift


def test_mask_margin_is_zero_where_no_mask_is_one_key_off():
    """Full attention has no window and no diagonal to shift."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 16, 16)).astype(
        np.float32)) for _ in range(3))
    got = ref.attention(q, k, v, causal=False)
    assert ref.mask_margin(got + 1.0, q, k, v, causal=False) == 0.0
