"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6, first layer
dense [arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    num_experts=64, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1408, first_k_dense=1,
    source="arXiv:2401.06066",
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-moe-16b-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=8, d_ff=64, vocab_size=512, head_dim=16,
    num_experts=8, experts_per_token=2, num_shared_experts=1, moe_d_ff=64,
)
