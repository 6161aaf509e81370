"""internvl2-76b — VLM: InternViT frontend (STUB) + InternLM2-like 80L backbone
[arXiv:2404.16821; unverified]. Backbone only; patch embeddings precomputed.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    frontend_stub=True, stub_prefix_len=256,
    source="arXiv:2404.16821",
)

SMOKE_CONFIG = CONFIG.replace(
    name="internvl2-76b-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=16, stub_prefix_len=8,
)
