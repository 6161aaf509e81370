"""The port on the CUDA card: the flash kernel against its plain version,
and the smoke engine on the card against the same engine on the host.

Every test here carries the ``cuda`` marker and skips without a card; on
the card's machine run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: 1e-5 in f32 (the kernel does true f32 FMA, no TF32), 2e-2 in
bf16 (one bf16 rounding of the output on each side).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.flash_attention import ops, ref
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
