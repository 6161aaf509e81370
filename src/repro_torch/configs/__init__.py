from repro_torch.configs.base import ARCH_NAMES, ModelConfig, get, get_smoke

__all__ = ["ARCH_NAMES", "ModelConfig", "get", "get_smoke"]
