"""The port's dpa_matmul and int8 quantized linear against the reference.

On the CPU the wrapper runs its kernel's plain version; it is held against
the Pallas TPU kernel (interpret mode, through the reference's ``ops``) and
its oracle over the sweeps of ``tests/test_kernels.py``, on the same inputs
made with numpy. Tolerances:
- ``dpa4`` is exact: int8 products summed in int32 (JAX) and f64 (the
  plain version) give the same integers;
- ``fma_f32``: the reference test's rtol 1e-5*sqrt(k) (+1e-6), atol 4e-5:
  only the f32 summation order differs;
- ``dpa2``: the same tolerance. Both sides round the inputs to bf16 the same
  way and sum exact products in f32, so again only the order differs (the
  reference test allows 2e-2*sqrt(k) against its own oracle);
- ``quantize_int8``: codes and scales bitwise (round half to even on both
  sides);
- ``quantized_linear``: rtol 1e-6, atol 1e-6: the same exact integer sum,
  then two f32 multiplies in the same order on both sides.
The CUDA kernel itself is held against the plain version on the card
(``cuda`` marker, ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.kernels.dpa_matmul import ops as jops
from repro.kernels.dpa_matmul import ref as jref
from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
from repro_torch.kernels.dpa_matmul import ops, ref

SHAPES = [(128, 256, 128), (256, 512, 128), (64, 128, 64)]


def _inputs(rng, m, k, n, variant):
    if variant == "dpa4":
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    else:
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = rng.normal(size=(k, n)).astype(np.float32)
    return (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a),
                                              torch.from_numpy(b))


@pytest.mark.parametrize("variant", ["fma_f32", "dpa2", "dpa4"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dpa_matmul_matches_pallas(variant, m, k, n):
    (aj, bj), (at, bt) = _inputs(np.random.default_rng(2), m, k, n, variant)
    got = ops.matmul(at, bt, variant=variant)
    pallas = np.asarray(jops.matmul(aj, bj, variant=variant, interpret=True))
    oracle = np.asarray(jref.matmul(aj, bj, variant))
    if variant == "dpa4":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), pallas)
        np.testing.assert_array_equal(got.numpy(), oracle)
    else:
        assert got.dtype == torch.float32
        for want in (pallas, oracle):
            np.testing.assert_allclose(got.numpy(), want,
                                       rtol=1e-5 * k ** 0.5 + 1e-6,
                                       atol=4e-5)


@settings(max_examples=20, deadline=None)
@given(m=st.sampled_from([64, 128]), k=st.sampled_from([128, 256]),
       n=st.sampled_from([64, 128]), seed=st.integers(0, 2**16))
def test_dpa4_exact_against_jax_property(m, k, n, seed):
    (aj, bj), (at, bt) = _inputs(np.random.default_rng(seed), m, k, n,
                                 "dpa4")
    got = dk.dpa_matmul(at, bt, variant="dpa4")
    want = jops.matmul(aj, bj, variant="dpa4", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dpa_casts_like_the_reference():
    """f32 inputs: dpa2 rounds them to bf16, dpa4 truncates them to int8,
    as the reference's ``astype`` does."""
    rng = np.random.default_rng(5)
    a = (rng.normal(size=(64, 128)) * 3).astype(np.float32)
    b = (rng.normal(size=(128, 64)) * 3).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got4 = dk.dpa_matmul(at, bt, variant="dpa4")
    np.testing.assert_array_equal(
        got4.numpy(), np.asarray(jref.matmul(jnp.asarray(a), jnp.asarray(b),
                                             "dpa4")))
    got2 = dk.dpa_matmul(at, bt, variant="dpa2")
    np.testing.assert_allclose(
        got2.numpy(), np.asarray(jref.matmul(jnp.asarray(a), jnp.asarray(b),
                                             "dpa2")),
        rtol=1e-5 * 128 ** 0.5 + 1e-6, atol=4e-5)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_codes_and_scales_bitwise(axis):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    # a zero row and column (scale 1) and exact halves (round half to even)
    x[3, :] = 0.0
    x[:, 5] = 0.0
    x[7, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[:6, 9] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    q, s = ops.quantize_int8(torch.from_numpy(x), axis)
    qj, sj = jops.quantize_int8(jnp.asarray(x), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_quantized_linear_matches_jax_and_stays_close_to_fp():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 64)) / np.sqrt(128)).astype(np.float32)
    got = ops.quantized_linear(torch.from_numpy(x), torch.from_numpy(w))
    want = jops.quantized_linear(jnp.asarray(x), jnp.asarray(w),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    fp = x @ w
    err = np.abs(got.numpy() - fp) / (np.abs(fp) + 1e-2)
    assert np.median(err) < 0.05


@pytest.mark.parametrize("shape", ["m", "n", "k", "inner"])
def test_non_divisible_shapes_raise_value_error(shape):
    a, b = torch.zeros(128, 256), torch.zeros(256, 128)
    if shape == "m":
        a = torch.zeros(200, 256)
    elif shape == "n":
        b = torch.zeros(256, 200)
    elif shape == "k":
        a, b = torch.zeros(128, 300), torch.zeros(300, 128)
    elif shape == "inner":
        b = torch.zeros(128, 128)
    with pytest.raises(ValueError):
        dk.dpa_matmul(a, b, variant="dpa2")


def test_unknown_variant_and_device_raise():
    a = torch.zeros(64, 64)
    with pytest.raises(ValueError):
        dk.dpa_matmul(a, a, variant="fp8")
    with pytest.raises(ValueError):
        dk.dpa_matmul(a.to("meta"), a.to("meta"), variant="dpa2")


def test_one_compile_per_new_signature_like_the_reference():
    (aj, bj), (at, bt) = _inputs(np.random.default_rng(7), 32, 48, 16,
                                 "fma_f32")
    (a2j, b2j), (a2t, b2t) = _inputs(np.random.default_rng(8), 16, 48, 16,
                                     "fma_f32")
    calls = [((at, bt), (aj, bj), "fma_f32"), ((at, bt), (aj, bj), "fma_f32"),
             ((at, bt), (aj, bj), "dpa2"), ((at, bt), (aj, bj), "dpa4"),
             ((a2t, b2t), (a2j, b2j), "dpa2")]
    before = (ops.stats.compiles("dpa/matmul"),
              jops.stats.compiles("dpa/matmul"))
    for targs, jargs, v in calls:
        ops.matmul(*targs, variant=v)
        jops.matmul(*jargs, variant=v, interpret=True)
    got = ops.stats.compiles("dpa/matmul") - before[0]
    want = jops.stats.compiles("dpa/matmul") - before[1]
    assert got == want == 4


def test_cpu_path_is_the_plain_version_and_not_counted():
    (_, _), (at, bt) = _inputs(np.random.default_rng(9), 64, 128, 64, "dpa4")
    before, before_routes = dict(dk.launches), dict(dk.route_launches)
    assert torch.equal(dk.dpa_matmul(at, bt, variant="dpa4"),
                       ref.matmul(at, bt, "dpa4"))
    assert dk.launches == before
    assert dk.route_launches == before_routes


# the kernel's route and tile planner (``dpa_matmul.plan``): pure Python,
# so its rules are held here on every shape the wrapper accepts (M and N
# below 128 or multiples of 128, K below 256 or a multiple of 256)
H100_SMS = 132
_dim = {
    "mn": st.one_of(st.integers(1, 127), st.integers(1, 64).map(
        lambda j: 128 * j)),
    "k": st.one_of(st.integers(1, 255), st.integers(1, 32).map(
        lambda j: 256 * j)),
}


def _blocks(m, n, bm, bn):
    return -(-m // bm) * -(-n // bn)


@pytest.mark.parametrize("variant", ["fma_f32", "dpa2", "dpa4"])
@settings(max_examples=200, deadline=None)
@given(m=_dim["mn"], n=_dim["mn"], k=_dim["k"],
       sms=st.sampled_from([1, 16, H100_SMS, 1000]))
def test_plan_maps_every_accepted_shape_to_one_route_and_tile_property(
        variant, m, n, k, sms):
    route, bm, bn = dk.plan(m, n, k, variant, sms)
    assert route in dk.ROUTES[variant]
    assert (bm, bn) in dk.TILES[route]
    # the shape alone decides: the same answer every time
    assert dk.plan(m, n, k, variant, sms) == (route, bm, bn)
    # the largest tile that fills sms blocks, else the smallest
    filling = [t for t in dk.TILES[route] if _blocks(m, n, *t) >= sms]
    assert (bm, bn) == (filling[0] if filling else dk.TILES[route][-1])


@settings(max_examples=300, deadline=None)
@given(m=_dim["mn"], n=_dim["mn"], k=_dim["k"])
def test_plan_gives_tma_only_shapes_it_can_describe_property(m, n, k):
    """dpa2 takes wgmma exactly where TMA can describe A [M,K] and B [K,N]
    in bf16: row strides of a multiple of 16 bytes."""
    route, _, _ = dk.plan(m, n, k, "dpa2", H100_SMS)
    describable = (2 * k) % 16 == 0 and (2 * n) % 16 == 0
    assert (route == "wgmma") == describable
    assert route == ("wgmma" if describable else "mma")


@pytest.mark.parametrize("m,k,n,route", [
    (64, 100, 64, "mma"),        # A rows of 200 bytes
    (64, 64, 100, "mma"),        # B rows of 200 bytes
    (96, 200, 640, "wgmma"),     # ragged against the tile and the stage
    (8, 128, 64, "wgmma"),       # M below 64
    (72, 99, 117, "mma"),        # K and N odd
    (4096, 4096, 4096, "wgmma"),
])
def test_plan_routes_dpa2_edge_shapes(m, k, n, route):
    assert dk.plan(m, n, k, "dpa2", H100_SMS)[0] == route


@pytest.mark.parametrize("variant", ["fma_f32", "dpa2"])
def test_plan_fills_the_card_at_the_bench_size(variant):
    """512^3 gets at least 32 blocks on an H100's 132 SMs (a 128x128 tile
    gives 16)."""
    route, bm, bn = dk.plan(512, 512, 512, variant, H100_SMS)
    assert _blocks(512, 512, bm, bn) >= 32
    # and the largest tile where it fills the card
    assert dk.plan(4096, 4096, 4096, variant, H100_SMS)[1:] == \
        dk.TILES[route][0]


@settings(max_examples=200, deadline=None)
@given(m=_dim["mn"], n=_dim["mn"], k=_dim["k"],
       sms=st.integers(1, 2000))
def test_plan_keeps_fma_off_the_tensor_cores_and_dpa4_on_mma_property(
        m, n, k, sms):
    assert dk.plan(m, n, k, "fma_f32", sms)[0] == "ffma"
    assert dk.plan(m, n, k, "dpa4", sms) == ("mma", 128, 128)


def test_plan_refuses_an_unknown_variant():
    with pytest.raises(ValueError):
        dk.plan(64, 64, 64, "fp8", H100_SMS)


def test_route_counts_cover_every_route_of_every_variant():
    assert set(dk.route_launches) == {
        f"{v}/{r}" for v, rs in dk.ROUTES.items() for r in rs}
    assert set(dk.ROUTES) == set(dk.VARIANTS)
    assert all(r in dk.TILES and r in dk.ROUTE_CODES
               for rs in dk.ROUTES.values() for r in rs)


@pytest.mark.parametrize("case", ["cpu", "inner", "rank", "device",
                                  "route", "tile", "variant"])
def test_launch_checks_its_operands_and_plan(case):
    """``launch`` runs only [M,K] @ [K,N] CUDA tensors of one device, on a
    route and tile the variant has; anything else raises ValueError before
    the library is loaded (no kernel reads past B or takes a host
    pointer)."""
    a, b = torch.zeros(64, 64), torch.zeros(64, 64)
    variant, route, tile = "dpa2", "wgmma", (64, 64)
    if case == "inner":
        b = torch.zeros(32, 64)
    elif case == "rank":
        a = torch.zeros(1, 64, 64)
    elif case == "device":
        b = b.to("meta")
    elif case == "route":
        variant = "fma_f32"
    elif case == "tile":
        tile = (128, 128)
    elif case == "variant":
        variant = "fp8"
    with pytest.raises(ValueError):
        dk.launch(a, b, variant, route, *tile)
