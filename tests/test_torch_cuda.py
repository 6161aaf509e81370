"""The port on the CUDA card: the flash, STREAM and dpa_matmul kernels
against their plain versions, the smoke engine on the card against the
same engine on the host, and a training forward and backward whose
attention weights get their gradients through the flash kernel.

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_custom_op_is_the_direct_launch_and_is_counted(dtype):
    """The forward through ``torch.ops.repro_torch.flash_fwd`` is bitwise
    the planned kernel launched directly; the op counter sees it on CUDA
    tensors, as one op of 4·B·H·S·T·D FLOPs, counted once as a launch."""
    _need_cuda()
    from repro_torch.perf import op_cost
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (b, h, hkv, s, t, d, causal, window, off) in CASES:
        q = torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        route, bm = ops.plan(b, h, hkv, s, t, d, dtype, sms)
        direct = ops.launch(q, k, v, route=route, block_m=bm, **kw)
        before = ops.launches
        with op_cost.OpCounter() as c:
            got = torch.ops.repro_torch.flash_fwd(q, k, v, causal, window,
                                                  off)
        assert ops.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, direct), (b, h, hkv, s, t, d, causal)
        assert c.flops == 4 * b * h * s * t * d
        assert c.by_op[("flash_fwd", 1.0)][2] == 1


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


# the full-width shapes the dense family's prefills give the kernel: gemma3
# (32 q / 16 kv heads) local layers over their own keys at the prompt
# buckets S 128, 256, 1024 (the window edge at the last row) and 2048 and
# at S 1500 (a window start inside a key tile), its global layers at those
# buckets and S 200 over T = max_seq 2048, the static batch of 4 both ways;
# qwen3 (64 / 8) and deepseek (56 / 8)
MODEL_CASES = [
    (1, 32, 16, 2048, 2048, 128, True, 1024, 0),
    (1, 32, 16, 2048, 2048, 128, True, None, 0),
    (1, 32, 16, 1500, 1500, 128, True, 1024, 0),
    (4, 32, 16, 2048, 2048, 128, True, 1024, 0),
    (1, 32, 16, 200, 2048, 128, True, None, 0),
    (1, 64, 8, 256, 512, 128, True, None, 0),
    (1, 56, 8, 130, 512, 128, True, None, 128),
    (1, 32, 16, 128, 128, 128, True, 1024, 0),
    (1, 32, 16, 256, 256, 128, True, 1024, 0),
    (1, 32, 16, 1024, 1024, 128, True, 1024, 0),
    (1, 32, 16, 128, 2048, 128, True, None, 0),
    (1, 32, 16, 256, 2048, 128, True, None, 0),
    (1, 32, 16, 1024, 2048, 128, True, None, 0),
    (4, 32, 16, 2048, 2048, 128, True, None, 0),
    (1, 32, 16, 2048, 2048, 128, True, 64, 0),
]
#: the largest ratio ``ref.mask_margin`` may read (a mask one key off reads
#: about 1)
MASK_MARGIN = 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("case", MODEL_CASES, ids=str)
def test_flash_at_the_dense_models_shapes(case):
    """bf16 on every route and tile that takes the inputs, against the
    plain version by max|err| and by the mask margin; the planned call on
    wgmma, counted with its window."""
    _need_cuda()
    b, h, hkv, s, t, d, causal, window, off = case
    g = torch.Generator(device="cuda")
    g.manual_seed(s + h)
    q, k, v = (torch.randn(b, n, m, d, device="cuda", generator=g).to(
        torch.bfloat16) for n, m in ((h, s), (hkv, t), (hkv, t)))
    want = ref.attention(q, k, v, causal=causal, window=window, q_offset=off)
    before, windowed = dict(ops.route_launches), ops.window_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=off)
    assert {r: c - before[r] for r, c in ops.route_launches.items()
            if c != before[r]} == {"wgmma": 1}
    assert ops.window_launches == windowed + (window is not None)
    outs = {("planned", 64): got}
    for route, bm in _routes(torch.bfloat16, d):
        outs[(route, bm)] = ops.launch(q, k, v, causal=causal, window=window,
                                       q_offset=off, route=route, block_m=bm)
    torch.cuda.synchronize()
    for key, out in outs.items():
        err = (out.float() - want.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16], (key, case)
        assert ref.mask_margin(out, q, k, v, causal=causal, window=window,
                               q_offset=off) <= MASK_MARGIN, (key, case)


@pytest.mark.cuda
def test_window_smoke_engine_on_the_card_matches_the_host():
    """gemma3's smoke model in f32, decoding past its 32-slot rings: the
    card (flash on ffma, windowed on local layers) emits the host's
    tokens."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("gemma3-27b").replace(dtype="float32")
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 12, 25, 50, 30)]
    out = {}
    for dev, params in (("cpu", host), ("cuda", _to(host, "cuda"))):
        reqs = [Request(i, p.copy(), max_new_tokens=10)
                for i, p in enumerate(prompts)]
        ops.launches, ops.window_launches = 0, 0
        stats = ContinuousEngine(model, params, batch_size=2, max_seq=64,
                                 telemetry=False).serve(reqs)
        out[dev] = ([r.output for r in reqs], stats,
                    (ops.launches, ops.window_launches))
    (cpu_tok, cpu_stats, cpu_l), (gpu_tok, gpu_stats, gpu_l) = (
        out["cpu"], out["cuda"])
    assert gpu_tok == cpu_tok
    for key in ("completed", "prefill_compiles", "decode_compiles",
                "adapter"):
        assert gpu_stats[key] == cpu_stats[key]
    assert cpu_l == (0, 0)
    n = gpu_stats["prefills"]
    assert gpu_l == (cfg.num_layers * n, 4 * n)   # 4 of 6 layers local


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


@pytest.mark.cuda
def test_training_gives_every_attention_weight_a_gradient_on_the_card():
    """bf16 forward and backward on the card (the flash kernel's wgmma
    route, D 64, under its autograd Function): every attention weight gets
    a nonzero gradient, equal to the host's (the plain version) on the same
    f32 master weights to 5e-2 of the host's max|grad| per leaf (bf16
    compute on both sides, rounded in other places; a missing gradient
    reads 1)."""
    _need_cuda()
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.step import StepConfig, make_grad_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("granite-20b").replace(head_dim=64)
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(0), "cpu",
                      dtype=torch.float32)
    card = tree_map(torch.Tensor.cuda, host)
    batch = SyntheticTokens(DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                       seq_len=64, global_batch=2)).batch(0)
    grad_fn = make_grad_fn(model, StepConfig())
    before = dict(ops.route_launches)
    _, gc = grad_fn(card, {k: torch.from_numpy(x).cuda()
                           for k, x in batch.items()})
    torch.cuda.synchronize()
    taken = {r: c - before[r] for r, c in ops.route_launches.items()}
    # the forward and the remat recompute of each layer
    assert taken == {"wgmma": 2 * cfg.num_layers, "ffma": 0}
    _, gh = grad_fn(host, {k: torch.from_numpy(x)
                           for k, x in batch.items()})
    for name in ("wq", "wk", "wv", "wo"):
        got = gc["layers"]["attn"][name].cpu()
        want = gh["layers"]["attn"][name]
        assert float(got.abs().max()) > 0, name
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 5e-2, (name, err)


_MOE_LAYER = {}


def _moe_layer(cfg):
    """One MoE layer's f32 weights N(0, 1/fan_in) from seed 0, on the host
    and on the card (made once)."""
    from repro_torch.models import moe
    if not _MOE_LAYER:
        g = torch.Generator().manual_seed(0)

        def make(spec):
            if isinstance(spec, dict):
                return {k: make(v) for k, v in spec.items()}
            shape, fan_in = spec
            return torch.randn(shape[1:], generator=g) / fan_in ** 0.5

        host = make(moe.moe_param_shapes(cfg, 1))
        card = {k: (v.cuda() if not isinstance(v, dict) else
                    {n: u.cuda() for n, u in v.items()})
                for k, v in host.items()}
        _MOE_LAYER.update(host=host, card=card)
    return _MOE_LAYER["host"], _MOE_LAYER["card"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(1, 256), (3, 1), (4, 1)])
def test_moe_layer_on_the_card_matches_the_host(b, s):
    """One MoE layer of deepseek-moe-16b's published width (64 experts
    top-6, d 2048, moe_d_ff 1408, 2 shared) in f32 from seed 0, on the
    card against the host (TF32 off): a 256-token prefill group (capacity
    30), a 3-row decode group (capacity 1: rows compete and drop) and 4
    groups of one row. Routing integers equal (the router logits of random
    inputs sit far from a tie at the top-k cut: the smallest margin is
    checked above 1e-5), the output within 1e-4 of max|y|, and two runs on
    the card equal bitwise (a fixed-order combine)."""
    _need_cuda()
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("deepseek-moe-16b").replace(dtype="float32")
    host, card = _moe_layer(cfg)
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator()
                    .manual_seed(b))
    groups = moe.n_groups(b)
    tg = b * s // groups
    cap = moe.capacity_for(cfg, tg)
    xf = x.reshape(groups, tg, cfg.d_model)
    probs = torch.softmax(xf @ host["router"], dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    k = cfg.experts_per_token
    assert float((top[..., k - 1] - top[..., k]).min()) > 1e-5
    routed = [moe.route(xs, xs @ p["router"], cfg, cap)
              for xs, p in ((xf, host), (xf.cuda(), card))]
    (_, (slot_h, tok_h, order_h), w_h, keep_h, _), \
        (_, (slot_c, tok_c, order_c), w_c, keep_c, _) = routed
    for got, want in ((slot_c, slot_h), (tok_c, tok_h), (order_c, order_h),
                      (keep_c, keep_h)):
        assert torch.equal(got.cpu(), want)
    want, _ = moe.moe_apply(x, host, cfg)
    got, _ = moe.moe_apply(x.cuda(), card, cfg)
    again, _ = moe.moe_apply(x.cuda(), card, cfg)
    assert torch.equal(got, again)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err


# the recurrent families' attention at full width: head dim 64, MHA (g =
# 1). whisper-small's encoder (non-causal over 1500 frames, not a multiple
# of the 64-key tile) and a decoder chunk; zamba2-1.2b's shared attention,
# a cold 256-token chunk, one at q_offset 256 and a 2-token one
RECURRENT_FLASH = [
    (1, 12, 12, 1500, 1500, 64, False, None, 0),
    (1, 12, 12, 128, 512, 64, True, None, 128),
    (1, 32, 32, 256, 512, 64, True, None, 0),
    (1, 32, 32, 64, 512, 64, True, None, 256),
    (1, 32, 32, 2, 512, 64, True, None, 320),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_the_recurrent_families_shapes(dtype):
    """The planned call (wgmma for bf16, ffma for f32) against the plain
    version at each shape, by max|err| and by the mask margin."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    want_route = "wgmma" if dtype == torch.bfloat16 else "ffma"
    for (b, h, hkv, s, t, d, causal, window, off) in RECURRENT_FLASH:
        q = torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dtype)
        before = dict(ops.route_launches)
        got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
        assert ops.route_launches[want_route] == before[want_route] + 1
        want = ref.attention(q, k, v, causal=causal, q_offset=off)
        err = (got.float() - want.float()).abs().max().item()
        margin = ref.mask_margin(got, q, k, v, causal=causal, q_offset=off)
        assert err <= TOL[dtype] and margin <= 0.25, (s, t, causal, off,
                                                      err, margin)


def _f32_layer(spec, seed):
    """An unstacked layer's f32 weights N(0, 1/fan_in) from ``seed`` (ones
    and zeros where the spec says), on the host and on the card."""
    from repro_torch.models import common
    host = common.layer_of(common.init_tree(
        spec, torch.Generator().manual_seed(seed), "cpu", torch.float32), 0)
    return host, common.tree_map(lambda t: t.cuda(), host)


def _held(got, want, what):
    got, want = got.float().cpu(), want.float()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= 1e-4, (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_recurrent_layer_on_the_card_matches_the_host(family):
    """One layer of each recurrent family at its published width in f32 on
    the card against the host (TF32 off): xlstm-1.3b's mLSTM block (a
    64-token chunk, then a decode step, state carried) and sLSTM block (16
    tokens on a carried state); zamba2-1.2b's mamba2 block (the same) and
    its shared attention (a 64-token chunk into its cache, flash's ffma
    route); whisper-small cut to one encoder and one decoder layer (a
    prefill with 1500 frames, then a decode step). Outputs and every state
    leaf within 1e-4 of max|host|."""
    _need_cuda()
    from repro_torch.models import common, mamba2, whisper, xlstm
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(7)
    cuda = lambda tree: common.tree_map(lambda t: t.cuda(), tree)  # noqa
    if family == "ssm":
        cfg = configs.get("xlstm-1.3b").replace(dtype="float32")
        m = xlstm.XLSTM(cfg)
        st = common.tree_map(lambda t: t[:1].clone(),
                             m.init_cache(1, 8, device="cpu")["mlstm"])
        host, card = _f32_layer(xlstm.mlstm_shapes(cfg, 1), 0)
        sts = {"host": st, "card": cuda(st)}
        for t in (64, 1):
            x = torch.randn(1, t, cfg.d_model, generator=g)
            y_h = xlstm.mlstm_block(x, host, cfg, tuple(s[0] for s in
                                                         sts["host"]))
            y_c = xlstm.mlstm_block(x.cuda(), card, cfg,
                                    tuple(s[0] for s in sts["card"]))
            _held(y_c, y_h, f"mLSTM y (T {t})")
            for a, b in zip(sts["card"], sts["host"]):
                _held(a, b, f"mLSTM state (T {t})")
        slstm = common.init_tree(xlstm.slstm_shapes(cfg),
                                 torch.Generator().manual_seed(1), "cpu",
                                 torch.float32)
        st = tuple(0.1 * torch.randn(1, cfg.num_heads, cfg.d_model
                                     // cfg.num_heads, generator=g)
                   for _ in range(4))
        st_c = cuda(st)
        x = torch.randn(1, 16, cfg.d_model, generator=g)
        _held(xlstm.slstm_block(x.cuda(), cuda(slstm), cfg, st_c),
              xlstm.slstm_block(x, slstm, cfg, st), "sLSTM y")
        for a, b in zip(st_c, st):
            _held(a, b, "sLSTM state")
    elif family == "hybrid":
        cfg = configs.get("zamba2-1.2b").replace(dtype="float32")
        m = mamba2.Zamba2(cfg)
        st = common.tree_map(lambda t: t[:1].clone(),
                             m.init_cache(1, 8, device="cpu")["mamba"])
        host, card = _f32_layer(mamba2.mamba_shapes(cfg, 1), 0)
        sts = {"host": st, "card": cuda(st)}
        for t in (64, 1):
            x = torch.randn(1, t, cfg.d_model, generator=g)
            y_h = mamba2.mamba_block(x, host, cfg, tuple(s[0] for s in
                                                          sts["host"]))
            y_c = mamba2.mamba_block(x.cuda(), card, cfg,
                                     tuple(s[0] for s in sts["card"]))
            _held(y_c, y_h, f"mamba2 y (T {t})")
            for a, b in zip(sts["card"], sts["host"]):
                _held(a, b, f"mamba2 state (T {t})")
        shared = common.init_tree(mamba2.param_shapes(cfg)["shared_attn"],
                                  torch.Generator().manual_seed(2), "cpu",
                                  torch.float32)
        cache = m.init_cache(1, 128, torch.float32, device="cpu")["attn_0"]
        cache_c = cuda(cache)
        x = torch.randn(1, 64, cfg.d_model, generator=g)
        pos = torch.arange(64) + 32
        _held(m._shared_attn(x.cuda(), cuda(shared), pos.cuda(), cache_c,
                             32),
              m._shared_attn(x, shared, pos, cache, 32), "shared attention")
        for a, b in zip(cache_c, cache):
            _held(a, b, "shared attention KV")
    else:
        cfg = configs.get("whisper-small").replace(
            dtype="float32", num_layers=1, enc_layers=1)
        m = whisper.Whisper(cfg)
        host = m.init(torch.Generator().manual_seed(3), "cpu")
        card = cuda(host)
        frames = torch.randn(1, cfg.enc_seq, cfg.d_model, generator=g)
        tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=g)
        caches = {"host": m.init_cache(1, 64, torch.float32, device="cpu")}
        caches["card"] = cuda(caches["host"])
        l_h, _ = m.prefill(host, {"tokens": tokens, "frames": frames},
                           caches["host"], start_pos=0)
        l_c, _ = m.prefill(card, {"tokens": tokens.cuda(),
                                  "frames": frames.cuda()},
                           caches["card"], start_pos=0)
        _held(l_c, l_h, "whisper prefill logits")
        tok = l_h.argmax(-1)
        pos = torch.tensor([8])
        d_h, _ = m.decode_step(host, tok, pos, caches["host"])
        d_c, _ = m.decode_step(card, tok.cuda(), pos.cuda(), caches["card"])
        _held(d_c, d_h, "whisper decode logits")
        for a, b in zip(_tree_leaves(caches["card"]),
                        _tree_leaves(caches["host"])):
            _held(a, b, "whisper caches")


def _tree_leaves(tree):
    """The tensors of a dict/tuple tree, in order."""
    out = []
    from repro_torch.models import common
    common.tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# the parallel layer at one NCCL rank (one card); two-card runs skip here


def _card_group(tmp_path):
    from torch_dist_worker import one_rank
    torch.cuda.set_device(0)
    return one_rank(tmp_path, backend="cpu:gloo,cuda:nccl")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-20b", "deepseek-moe-16b"])
def test_sharded_step_at_one_nccl_rank_equals_the_unsharded_step(tmp_path,
                                                                 arch):
    """The smoke model's f32 masters from seed 0 on the card, 2 steps of
    batch 4 x 32 in 2 microbatches: ``ShardedTrainStep`` on
    ``make_host_mesh(1, 1, 1, "cuda")`` against ``make_train_step`` of the
    same model on that mesh, bit for bit (one rank: every collective is
    the identity)."""
    _need_cuda()
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                           batch_to_device)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                             tree_leaves)
    from repro_torch.train.step import (ShardedTrainStep, StepConfig,
                                        TrainState, make_train_step)
    cfg = configs.get_smoke(arch)
    data = SyntheticTokens(DataConfig(seed=2, vocab_size=cfg.vocab_size,
                                      seq_len=32, global_batch=4), cfg)
    with _card_group(tmp_path):
        mesh = make_host_mesh(1, 1, 1, "cuda")
        runs = []
        for sharded in (False, True):
            model = build_model(cfg, mesh)
            params = model.init(torch.Generator("cuda").manual_seed(0),
                                "cuda", dtype=torch.float32)
            state = TrainState(params, init_opt_state(params))
            oc, sc = OptConfig(lr=1e-3), StepConfig(num_microbatches=2)
            if sharded:
                step = ShardedTrainStep(model, oc, sc, mesh)
                state = step.layout(state)
            else:
                step = make_train_step(model, oc, sc)
            out = []
            for i in range(2):
                state, m = step(state, batch_to_device(data.batch(i),
                                                       "cuda"))
                out.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append((out, [p.cpu() for p in tree_leaves(state.params)]))
    (plain, pp), (shard, sp) = runs
    assert plain == shard
    assert all(torch.equal(a, b) for a, b in zip(pp, sp))


@pytest.mark.cuda
def test_expert_parallel_at_one_nccl_rank_matches_the_grouped_path(tmp_path):
    """deepseek-moe's smoke MoE layer in f32 on the card: the
    expert-parallel path (both all-to-alls and the all-gather on NCCL)
    against the grouped path on the same one-rank mesh, y and the
    gradients within 1e-5 of max."""
    _need_cuda()
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common, moe
    from repro_torch.parallel.sharding import Sharder
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(4, 16, cfg.d_model, generator=g, device="cuda")
    with _card_group(tmp_path):
        shd = Sharder(make_host_mesh(1, 1, 1, "cuda"))
        out = []
        for impl in ("gspmd", "shard_map"):
            p = common.layer_of(common.init_tree(
                moe.moe_param_shapes(cfg, 1),
                torch.Generator("cuda").manual_seed(1), "cuda",
                torch.float32), 0)
            leaves = [p[k].requires_grad_() for k in ("router", "w_gate",
                                                      "w_up", "w_down")]
            y, aux = moe.moe_apply(x, p, cfg, shd, impl=impl)
            grads = torch.autograd.grad((y * y).sum() + aux, leaves)
            out.append((y.detach(), grads))
    (yg, gg), (ye, ge) = out
    assert float((ye - yg).abs().max()) <= 1e-5 * float(yg.abs().max())
    for a, b in zip(ge, gg):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_compressed_reduction_on_the_card_equals_the_host(tmp_path):
    """``compress_grads_over_pod`` at one rank, twice (error feedback), on
    the card over NCCL and on the host over gloo: outputs and error states
    equal bit for bit."""
    _need_cuda()
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import compress
    from repro_torch.train.optimizer import tree_leaves, tree_map
    g = torch.Generator().manual_seed(0)
    host = {"w": torch.randn(1000, 257, generator=g) * 1e-3,
            "b": {"a": torch.randn(4099, generator=g)}}
    card = tree_map(torch.Tensor.cuda, host)
    with _card_group(tmp_path):
        mesh = make_host_mesh(1, 1, 1, "cuda")
        got = []
        for tree in (card, host):
            r1, e1 = compress.compress_grads_over_pod(tree, mesh)
            r2, e2 = compress.compress_grads_over_pod(tree, mesh, e1)
            got.append([x.cpu() for t in (r1, e1, r2, e2)
                        for x in tree_leaves(t)])
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.cuda
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason=f"needs 2 cards; torch.cuda.device_count() is "
                           f"{torch.cuda.device_count()}")
def test_trainer_on_two_cards_under_torchrun(tmp_path):
    """``repro_torch.launch.train --mesh-data 2`` under torchrun on two
    cards (NCCL, one card a rank) runs and logs its steps."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "repro_torch.launch.train", "--smoke",
         "--mesh-data", "2", "--steps", "2", "--batch", "4", "--seq", "32",
         "--log-json", str(tmp_path / "log.json")],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    history = json.loads((tmp_path / "log.json").read_text())["history"]
    assert len(history) == 2 and all(np.isfinite(r["loss"])
                                     for r in history)


@pytest.mark.cuda
def test_kernel_events_returns_every_kernel_of_the_calls_and_no_marker():
    """``benchmarks.common.kernel_events`` brackets its profiler session
    with marker kernels and returns the calls' kernels alone: five calls
    of one flash launch give five flash kernels, the session whole."""
    _need_cuda()
    from repro_torch.benchmarks.common import MARKER, device_ms, kernel_events
    q, k, v = (torch.randn(1, 4, 128, 64, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    fn = lambda: ops.flash_attention(q, k, v)              # noqa: E731
    fn()
    torch.cuda.synchronize()
    events, whole = kernel_events(fn, 5)
    assert whole and len(events) == 5
    assert all("flash_fwd" in name and MARKER not in name
               for name, _ in events)
    assert device_ms(fn, n=5) > 0
