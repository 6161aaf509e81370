"""deepseek-coder-33b — llama-arch dense [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, head_dim=128,
    source="arXiv:2401.14196",
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-coder-33b-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=16,
)
