"""qwen3-32b — dense, GQA + qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-32b-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=16,
)
