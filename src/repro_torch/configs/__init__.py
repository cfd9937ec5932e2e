from repro_torch.configs.base import (SERVE_MODES, ModelConfig, ServeConfig,
                                      TenantTier, TrainConfig)
from repro_torch.configs.registry import ARCHS, get_config, list_archs
