from repro_torch.configs.base import (ModelConfig, available_archs,
                                     get_config, smoke_variant)

__all__ = ["ModelConfig", "available_archs", "get_config", "smoke_variant"]
