"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_conv_width=4,
    attn_every=6,          # shared attention block every 6 mamba layers
    subquadratic=True,
    source="arXiv:2411.15242",
)

SMOKE_CONFIG = CONFIG.replace(
    name="zamba2-1.2b-smoke", num_layers=6, d_model=128, num_heads=8,
    num_kv_heads=8, d_ff=256, vocab_size=512, head_dim=16,
    ssm_state=16, attn_every=3,
)
