from repro_torch.models.registry import (abstract_params, build_model,
                                        token_batch_specs)

__all__ = ["abstract_params", "build_model", "token_batch_specs"]
