"""whisper-small — encoder-decoder audio backbone, conv frontend STUB
[arXiv:2212.04356; unverified]. input_specs() provides precomputed frame
embeddings for the encoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    encoder_decoder=True, enc_layers=12, enc_seq=1500,
    frontend_stub=True,
    source="arXiv:2212.04356",
)

SMOKE_CONFIG = CONFIG.replace(
    name="whisper-small-smoke", num_layers=2, enc_layers=2, d_model=128,
    num_heads=8, num_kv_heads=8, d_ff=256, vocab_size=512, head_dim=16,
    enc_seq=64,
)
