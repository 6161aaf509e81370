"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the assignment: feed-forward lives inside the xLSTM blocks
(mLSTM up/down projection, gated FFN in sLSTM blocks).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    slstm_every=8,        # 7:1 mLSTM:sLSTM
    subquadratic=True,
    source="arXiv:2405.04517",
)

SMOKE_CONFIG = CONFIG.replace(
    name="xlstm-1.3b-smoke", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=32, vocab_size=512, slstm_every=2,
)
