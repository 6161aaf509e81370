"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    num_experts=64, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1408, first_k_dense=1,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="moonshot-v1-16b-a3b-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=8, d_ff=64, vocab_size=512, head_dim=16,
    num_experts=8, experts_per_token=2, num_shared_experts=1, moe_d_ff=64,
)
