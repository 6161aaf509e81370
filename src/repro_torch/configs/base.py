"""Config system: model architecture configs.

Every ported architecture gets one file in this package exporting CONFIG
(the full published config) and SMOKE_CONFIG (a reduced same-family config for
CPU smoke tests). ``repro_torch.configs.get(name)`` resolves either.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering all assigned families."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention pattern ---
    qk_norm: bool = False
    sliding_window: int = 0        # 0 = full attention
    local_global_period: int = 0   # gemma3: every Nth layer is global, rest local
    rope_theta: float = 10_000.0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0         # leading dense layers (deepseek-moe style)
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0             # mamba2 state size
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    slstm_every: int = 0           # xlstm: every Nth block is sLSTM (rest mLSTM)
    attn_every: int = 0            # zamba2: shared attention block every Nth layer

    # --- encoder-decoder (whisper) ---
    encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500            # whisper encoder frames (stub frontend)

    # --- modality stub ---
    frontend_stub: bool = False    # vlm/audio: inputs are precomputed embeddings
    stub_prefix_len: int = 256     # vlm: number of patch-embedding tokens

    # --- numerics ---
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "float32"   # master/storage dtype for training

    # --- mesh adaptation ---
    # Query heads padded up to a multiple of the TP axis. Padded heads get
    # zero-initialized wq rows and wo columns, making them exact no-ops
    # (function-preserving); 0 = no padding.
    pad_q_heads: int = 0

    # --- notes ---
    subquadratic: bool = False     # eligible for long_500k
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_heads(self) -> int:
        """Effective query-head count (after TP padding)."""
        return max(self.pad_q_heads, self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def adapt_for_mesh(self, model_axis_size: int) -> "ModelConfig":
        """Pad query heads to a multiple of the TP axis when needed.

        GQA ratio must stay integral: padded H must also be a multiple of
        num_kv_heads. kv heads are never padded (zero keys would perturb the
        softmax); indivisible kv heads are handled by cache sequence
        sharding instead (see launch.dryrun.serve_rules).
        """
        h = self.num_heads
        if h % model_axis_size == 0:
            return self
        import math
        step = (model_axis_size * self.num_kv_heads
                // math.gcd(model_axis_size, self.num_kv_heads))
        padded = ((h + step - 1) // step) * step
        if padded > 1.5 * h:
            # padding overhead too high (e.g. whisper 12H -> 48H on TP16):
            # stay unpadded; attention is replicated over the model axis,
            # which is acceptable for small models.
            return self
        return self.replace(pad_q_heads=padded)


#: the configs the port has (the reference registers ten; each later slice
#: adds the ones it serves)
ARCH_NAMES = [
    "granite-20b",
]


def _module_for(name: str):
    if name not in ARCH_NAMES:
        raise KeyError(f"config {name!r} is not ported yet (ported: "
                       f"{ARCH_NAMES})")
    mod_name = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get(name: str) -> ModelConfig:
    return _module_for(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module_for(name).SMOKE_CONFIG
