"""granite-20b — llama-arch dense code model [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    source="arXiv:2405.04324",
)

SMOKE_CONFIG = CONFIG.replace(
    name="granite-20b-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=1, d_ff=256, vocab_size=512, head_dim=16,
)
