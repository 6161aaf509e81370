"""The port on the CUDA card: the flash, STREAM and dpa_matmul kernels
against their plain versions, and the smoke engine on the card against the
same engine on the host.

Every test here carries the ``cuda`` marker and skips without a card; on
the card's machine run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: flash 1e-5 in f32 (the kernel does true f32 FMA, no TF32),
2e-2 in bf16 (one bf16 rounding of the output on each side; the wgmma
route also rounds the softmax weights to bf16, at most 2^-9 relative).
STREAM copy, scale, add, triad and write: equal to the plain version (the
kernel rounds after each operation, as eager PyTorch does; f32 triad is
not contracted into an FMA). STREAM read: ``ref.read_limit`` per row block, 1e-5 of
sum(|a|) plus in bf16 one bf16 ulp of the sum (another summation order).
dpa_matmul: dpa4 exact; fma_f32 and dpa2
rtol 1e-5*sqrt(k) + 1e-6, atol 4e-5 (f32 sums in another order) at the
reference tests' shapes; at the edges of the routes and on every tile,
``_dpa_limit`` (``chip_smoke.py``'s ``dpa_limit``: the same rule with the
rtol scaled by max(|want|, (|a| @ |b|) / sqrt(k)), since a K-term sum of
random sign can cancel to near zero).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
from repro_torch.kernels.dpa_matmul import ops as dpa_ops
from repro_torch.kernels.dpa_matmul import ref as dpa_ref
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.stream import ref as stream_ref
from repro_torch.kernels.stream import stream as sk
from repro_torch.models import build_model
from repro_torch.serve.engine import ContinuousEngine, Request

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# (B, H, Hkv, S, T, D, causal, window, q_offset)
CASES = [
    (1, 4, 1, 23, 40, 16, True, None, 17),
    (2, 8, 2, 8, 48, 32, True, None, 32),
    (1, 4, 4, 37, 64, 64, True, None, 0),
    (1, 48, 1, 200, 512, 128, True, None, 128),
    (1, 8, 8, 70, 70, 16, False, None, 0),
    (1, 4, 4, 100, 100, 128, True, 24, 0),
]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(dtype):
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for (b, h, hkv, s, t, d, causal, window, off) in CASES:
        q = torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        before = ops.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=off)
        assert ops.launches == before + 1
        want = ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype], (b, h, hkv, s, t, d, causal, window, off)


@pytest.mark.cuda
def test_flash_kernel_refuses_non_contiguous_input():
    _need_cuda()
    q = torch.zeros(1, 8, 4, 16, device="cuda").transpose(1, 2)
    k = torch.zeros(1, 4, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k, k)


# the edges of the wgmma route: 64-row tiles crossing a head boundary (S
# 200, S 100, S 130), S 64 with Hkv 1, S = 1, T below and not a multiple
# of the 64-key tile, a window after a prefix, Hkv 8 of 48 (g = 6), D 64,
# no causal mask
ROUTE_CASES = CASES + [
    (1, 48, 1, 64, 512, 128, True, None, 0),
    (1, 48, 1, 256, 512, 128, True, None, 0),
    (1, 48, 1, 1, 300, 128, True, None, 299),
    (1, 8, 2, 20, 40, 64, True, None, 20),
    (1, 48, 1, 100, 130, 128, True, None, 30),
    (1, 48, 1, 96, 512, 128, True, 80, 200),
    (1, 48, 8, 130, 300, 128, True, None, 100),
    (2, 48, 8, 77, 77, 64, True, None, 0),
    (1, 48, 1, 33, 77, 128, False, None, 0),
]


def _routes(dtype, d):
    """Every (route, tile) that takes these inputs."""
    out = [("ffma", bm) for bm in ops.TILES["ffma"]]
    if dtype == torch.bfloat16 and d in ops.WGMMA_HEAD_DIMS:
        out += [("wgmma", bm) for bm in ops.TILES["wgmma"]]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_every_route_and_tile_matches_plain_version(dtype):
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    for (b, h, hkv, s, t, d, causal, window, off) in ROUTE_CASES:
        q = torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        want = ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
        for route, bm in _routes(dtype, d):
            before = dict(ops.route_launches)
            got = ops.launch(q, k, v, causal=causal, window=window,
                             q_offset=off, route=route, block_m=bm)
            assert ops.route_launches[route] == before[route] + 1
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == q.shape
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[dtype], (route, bm, b, h, hkv, s, t, d, causal,
                                       window, off)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 128), (torch.bfloat16, 64), (torch.bfloat16, 16),
    (torch.float32, 128)])
def test_flash_counts_the_planned_route(dtype, d):
    _need_cuda()
    q = torch.randn(1, 48, 70, d, device="cuda").to(dtype)
    k = torch.randn(1, 1, 90, d, device="cuda").to(dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route, _ = ops.plan(1, 48, 1, 70, 90, d, dtype, sms)
    before, total = dict(ops.route_launches), ops.launches
    ops.flash_attention(q, k, k, q_offset=20)
    assert ops.launches == total + 1
    assert {r: c - before[r] for r, c in ops.route_launches.items()
            if c != before[r]} == {route: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,route,bm,shift,err", [
    (torch.float32, 128, "wgmma", 64, 0, RuntimeError),  # wgmma is bf16 only
    (torch.bfloat16, 32, "wgmma", 64, 0, RuntimeError),  # rows below a box
    (torch.bfloat16, 128, "wgmma", 64, 1, RuntimeError),  # TMA: 16 B aligned
    (torch.bfloat16, 128, "ffma", 128, 0, ValueError),   # no such tile
    (torch.bfloat16, 128, "wgmma", 128, 0, ValueError),
    (torch.bfloat16, 128, "wgmma", 256, 0, ValueError),
])
def test_flash_launch_refuses_a_plan_it_cannot_run(dtype, d, route, bm,
                                                   shift, err):
    _need_cuda()
    n = 8 * 16 * d
    q = torch.zeros(shift + n, device="cuda", dtype=dtype)[shift:].view(
        1, 8, 16, d)
    k = torch.zeros(1, 1, 16, d, device="cuda", dtype=dtype)
    before = dict(ops.route_launches)
    with pytest.raises(err):
        ops.launch(q, k, k, causal=True, window=None, q_offset=0,
                   route=route, block_m=bm)
    assert ops.route_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_sends_an_offset_view_to_the_ffma_route(which):
    """A contiguous bf16 D-128 view whose start is not 16-byte aligned is
    planned onto ffma (TMA cannot read it), counted there and right."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    shapes = {"q": (1, 48, 256, 128), "k": (1, 1, 512, 128),
              "v": (1, 1, 512, 128)}
    x = {}
    for name, shape in shapes.items():
        n = shape[0] * shape[1] * shape[2] * shape[3]
        shift = 1 if name == which else 0
        x[name] = torch.randn(shift + n, device="cuda", generator=g).to(
            torch.bfloat16)[shift:].view(shape)
    assert x[which].is_contiguous() and x[which].data_ptr() % 16 != 0
    before = dict(ops.route_launches)
    got = ops.flash_attention(x["q"], x["k"], x["v"], q_offset=0)
    assert {r: c - before[r] for r, c in ops.route_launches.items()
            if c != before[r]} == {"ffma": 1}
    torch.cuda.synchronize()
    want = ref.attention(x["q"], x["k"], x["v"], q_offset=0)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_smoke_engine_on_the_card_matches_the_host():
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("granite-20b").replace(dtype="float32")
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, 3 + 5 * i).astype(np.int32)]) for i in range(5)]
    out = {}
    for dev, params in (("cpu", host), ("cuda", _to(host, "cuda"))):
        reqs = [Request(i, p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        ops.launches = 0
        stats = ContinuousEngine(model, params, batch_size=2, max_seq=48,
                                 telemetry=False).serve(reqs)
        out[dev] = ([r.output for r in reqs], stats, ops.launches)
    (cpu_tok, cpu_stats, cpu_l), (gpu_tok, gpu_stats, gpu_l) = (
        out["cpu"], out["cuda"])
    assert gpu_tok == cpu_tok
    for key in ("completed", "prefill_compiles", "decode_compiles",
                "prefix_cache"):
        assert gpu_stats[key] == cpu_stats[key]
    assert cpu_l == 0                          # the host ran plain versions
    assert gpu_l == cfg.num_layers * gpu_stats["prefills"]


# the reference tests' shapes, ragged widths, and the benches' own shapes
# (bandwidth at 64 KB, 1 MB and 16 MB; the 8x8 launch-latency copy)
STREAM_SHAPES = [(64, 128), (256, 128), (128, 512), (1, 1001), (3, 333),
                 (16, 1024), (256, 1024), (4096, 1024), (8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernels_match_plain_versions(dtype):
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    for rows, cols in STREAM_SHAPES:
        a = torch.randn(rows, cols, device="cuda", generator=g).to(dtype)
        b = torch.randn(rows, cols, device="cuda", generator=g).to(dtype)
        pairs = {
            "stream_copy": (sk.stream_copy(a), stream_ref.copy(a)),
            "stream_scale": (sk.stream_scale(a, 1.7),
                             stream_ref.scale(a, 1.7)),
            "stream_add": (sk.stream_add(a, b), stream_ref.add(a, b)),
            "stream_triad": (sk.stream_triad(a, b, 1.7),
                             stream_ref.triad(a, b, 1.7)),
            "stream_write": (
                sk.stream_write((rows, cols), 1.7, dtype),
                stream_ref.write((rows, cols), 1.7, dtype, "cuda")),
        }
        for name, (got, want) in pairs.items():
            assert torch.equal(got, want), (name, rows, cols, dtype)
        for br in (8, 16, 256):
            got = sk.stream_read(a, block_rows=br)
            want = stream_ref.read(a, block_rows=br)
            assert got.shape == want.shape and got.dtype == dtype
            assert bool(((got.float() - want.float()).abs()
                         <= stream_ref.read_limit(a, want, br)).all()), (
                rows, cols, br, dtype)
    torch.cuda.synchronize()


def _stream_pairs(a, b, x):
    shape, dt = tuple(a.shape), a.dtype
    return {
        "stream_copy": (sk.stream_copy(a), stream_ref.copy(a)),
        "stream_scale": (sk.stream_scale(a, x), stream_ref.scale(a, x)),
        "stream_add": (sk.stream_add(a, b), stream_ref.add(a, b)),
        "stream_triad": (sk.stream_triad(a, b, x),
                         stream_ref.triad(a, b, x)),
        "stream_write": (sk.stream_write(shape, x, dt),
                         stream_ref.write(shape, x, dt, "cuda")),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_elementwise_at_16_mib_matches_plain_versions(dtype):
    """16 MiB, the bandwidth bench's size that fits in L2: bitwise."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    rows = (16 << 20) // (1024 * torch.tensor([], dtype=dtype).element_size())
    a = torch.randn(rows, 1024, device="cuda", generator=g).to(dtype)
    b = torch.randn(rows, 1024, device="cuda", generator=g).to(dtype)
    for name, (got, want) in _stream_pairs(a, b, 1.7).items():
        assert torch.equal(got, want), (name, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["a", "b"])
def test_stream_elementwise_on_unaligned_views_matches_plain_versions(
        dtype, which):
    """Contiguous views that start one element past a 16-byte boundary
    take the kernel's single-element path: bitwise."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    shape = (64, 1000)
    x = {}
    for name in ("a", "b"):
        shift = int(name == which)
        x[name] = torch.randn(shift + 64 * 1000, device="cuda",
                              generator=g).to(dtype)[shift:].view(shape)
    assert x[which].data_ptr() % 16 != 0
    for name, (got, want) in _stream_pairs(x["a"], x["b"], 1.7).items():
        if name != "stream_write":
            assert torch.equal(got, want), (name, dtype, which)


@pytest.mark.cuda
def test_stream_kernels_count_their_launches_and_refuse_ragged_rows():
    _need_cuda()
    a = torch.ones(64, 128, device="cuda")
    before = dict(sk.launches)
    sk.stream_copy(a)
    sk.stream_read(a, block_rows=16)
    assert sk.launches["stream_copy"] == before["stream_copy"] + 1
    assert sk.launches["stream_read"] == before["stream_read"] + 1
    with pytest.raises(ValueError, match="block_rows"):
        sk.stream_copy(torch.ones(300, 128, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        sk.stream_copy(torch.ones(128, 64, device="cuda").t())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fma_f32", "dpa2", "dpa4"])
def test_dpa_matmul_kernel_matches_plain_version(variant):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    for m, k, n in [(128, 256, 128), (256, 512, 128), (64, 128, 64),
                    (512, 512, 512)]:
        if variant == "dpa4":
            a = torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                              dtype=torch.int8)
        else:
            a = torch.randn(m, k, device="cuda", generator=g)
            b = torch.randn(k, n, device="cuda", generator=g)
        before = dk.launches[variant]
        got = dk.dpa_matmul(a, b, variant=variant)
        assert dk.launches[variant] == before + 1
        want = dpa_ref.matmul(a, b, variant)
        torch.cuda.synchronize()
        if variant == "dpa4":
            assert got.dtype == torch.int32 and torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want,
                                       rtol=1e-5 * k ** 0.5 + 1e-6,
                                       atol=4e-5)


@pytest.mark.cuda
def test_quantized_linear_on_the_card_matches_its_plain_composition():
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    x = torch.randn(64, 128, device="cuda", generator=g)
    w = torch.randn(128, 64, device="cuda", generator=g) / 128 ** 0.5
    got = dpa_ops.quantized_linear(x, w)
    xq, xs = dpa_ops.quantize_int8(x, axis=1)
    wq, ws = dpa_ops.quantize_int8(w, axis=0)
    want = dpa_ref.matmul(xq, wq, "dpa4").float() * xs * ws
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _dpa_inputs(m, k, n, variant, g):
    if variant == "dpa4":
        return (torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                              dtype=torch.int8))
    dt = torch.float32 if variant == "fma_f32" else torch.bfloat16
    return (torch.randn(m, k, device="cuda", generator=g).to(dt),
            torch.randn(k, n, device="cuda", generator=g).to(dt))


def _dpa_limit(a, b, want):
    k = a.shape[1]
    scale = torch.maximum(want.abs(),
                          (a.float().abs() @ b.float().abs()) / k ** 0.5)
    return 4e-5 + (1e-5 * k ** 0.5 + 1e-6) * scale


def _dpa_holds(got, want, a, b, variant):
    if variant == "dpa4":
        return got.dtype == torch.int32 and torch.equal(got, want)
    return got.dtype == torch.float32 and bool(
        ((got - want).abs() <= _dpa_limit(a, b, want)).all())


# (M, K, N): ragged against the wgmma tile and its 64-deep stage, M below
# 64, A rows and B rows of 200 bytes (TMA cannot describe them), and K and
# N odd (fma_f32's rows are not 16-byte aligned: its 4-byte copies)
DPA_EDGES = [(96, 200, 640), (8, 128, 64), (64, 100, 64), (64, 64, 100),
             (72, 99, 117)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fma_f32", "dpa2", "dpa4"])
def test_dpa_matmul_edges_take_their_planned_route(variant):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n in DPA_EDGES:
        a, b = _dpa_inputs(m, k, n, variant, g)
        route, _, _ = dk.plan(m, n, k, variant, sms)
        before = dict(dk.route_launches)
        got = dk.dpa_matmul(a, b, variant=variant)
        assert {r: c - before[r] for r, c in dk.route_launches.items()
                if c != before[r]} == {f"{variant}/{route}": 1}
        want = dpa_ref.matmul(a, b, variant)
        torch.cuda.synchronize()
        assert _dpa_holds(got, want, a, b, variant), (m, k, n)


# dpa4 on wgmma takes K % 16 == 0 and any M and N: one 64^3 tile, M and N
# ragged against both tiles with K 16 x 63, M below 64 with K 16 x 13, K
# 16 x 7 with M and N odd (odd rows: the transpose's byte loads, the
# epilogue's single stores), and 1024^3
DPA4_TILE_SHAPES = [(64, 64, 64), (300, 1008, 520), (8, 208, 72),
                    (72, 112, 117), (1024, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,route", [("dpa2", "wgmma"),
                                           ("fma_f32", "ffma"),
                                           ("dpa4", "wgmma")])
def test_dpa_matmul_every_tile_matches_plain_version(variant, route):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    # odd K and N only where the route takes rows of any alignment
    odd = [(72, 99, 117)] if route == "ffma" else []
    shapes = ([(64, 64, 64), (96, 200, 640), (8, 128, 64), (300, 1000, 520),
               (1024, 1024, 1024)] + odd if variant != "dpa4"
              else DPA4_TILE_SHAPES)
    for bm, bn in dk.TILES[route]:
        for m, k, n in shapes:
            a, b = _dpa_inputs(m, k, n, variant, g)
            got = dk.launch(a, b, variant, route, bm, bn)
            want = dpa_ref.matmul(a, b, variant)
            torch.cuda.synchronize()
            assert _dpa_holds(got, want, a, b, variant), (bm, bn, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 100, 64), (64, 64, 100)])
def test_dpa2_wgmma_route_refuses_rows_tma_cannot_describe(m, k, n):
    _need_cuda()
    a = torch.zeros(m, k, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(k, n, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError"):
        dk.launch(a, b, "dpa2", "wgmma", 64, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile", [(200, (64, 64)), (200, (128, 256)),
                                    (72, (64, 64))])
def test_dpa4_wgmma_route_refuses_k_tma_cannot_describe(k, tile):
    """int8 rows of A and B^T are K bytes: K % 16 != 0 raises, and neither
    the product nor the transpose is counted."""
    _need_cuda()
    a = torch.zeros(64, k, device="cuda", dtype=torch.int8)
    b = torch.zeros(k, 64, device="cuda", dtype=torch.int8)
    before = (dict(dk.route_launches), dict(dk.transposes))
    with pytest.raises(RuntimeError, match="cudaError"):
        dk.launch(a, b, "dpa4", "wgmma", *tile)
    assert (dict(dk.route_launches), dict(dk.transposes)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,shift", [(16, 1, 0), (112, 117, 0),
                                       (208, 72, 0), (1008, 520, 0),
                                       (2048, 4096, 0), (1008, 520, 1)])
def test_transpose_int8_kernel_matches_plain_version(k, n, shift):
    """The transpose dpa4's wgmma route runs first, alone: bitwise equal to
    ``b.t().contiguous()``, K and N ragged against its 128 x 128 tile, N
    not a multiple of 16 (byte loads), and B off a 16-byte boundary."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    b = torch.randint(-128, 128, (shift + k * n,), device="cuda",
                      generator=g, dtype=torch.int8)[shift:].view(k, n)
    before = dk.transposes["launches"]
    got = dk.transpose_int8(b)
    assert dk.transposes["launches"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (n, k) and torch.equal(got, b.t().contiguous())


@pytest.mark.cuda
def test_transpose_int8_refuses_k_not_a_multiple_of_16():
    _need_cuda()
    with pytest.raises(RuntimeError, match="cudaError"):
        dk.transpose_int8(torch.zeros(200, 64, device="cuda",
                                      dtype=torch.int8))
