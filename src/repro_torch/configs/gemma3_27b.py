"""gemma3-27b — dense, 5:1 local:global attention, qk-norm, 128k ctx
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    qk_norm=True, sliding_window=1024, local_global_period=6,
    rope_theta=1_000_000.0,
    # NOT subquadratic: global layers (every 6th) are full attention.
    source="hf:google/gemma-3-1b-pt",
)

SMOKE_CONFIG = CONFIG.replace(
    name="gemma3-27b-smoke", num_layers=6, d_model=128, num_heads=8,
    num_kv_heads=4, d_ff=256, vocab_size=512, head_dim=16,
    sliding_window=32, local_global_period=3,
)
