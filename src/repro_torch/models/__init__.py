from repro_torch.models.registry import abstract_params, build_model

__all__ = ["abstract_params", "build_model"]
