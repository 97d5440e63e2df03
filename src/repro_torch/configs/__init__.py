from repro_torch.configs.base import (EncDecConfig, FedTimeConfig,
                                      HybridConfig, MoEConfig, ModelConfig,
                                      SSMConfig, VLMConfig, XLSTMConfig)
from repro_torch.configs.registry import (ALL_ARCHS, get_config,
                                          get_smoke_config)

__all__ = [
    "EncDecConfig", "FedTimeConfig", "HybridConfig", "MoEConfig",
    "ModelConfig", "SSMConfig", "VLMConfig", "XLSTMConfig", "ALL_ARCHS",
    "get_config", "get_smoke_config",
]
