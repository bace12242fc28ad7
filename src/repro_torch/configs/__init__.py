"""Model configurations of the LM zoo (copies of ``repro.configs``)."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      MoEConfig, SSMConfig, ShapeConfig,
                                      get_config, get_smoke_config)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "get_config", "get_smoke_config"]
