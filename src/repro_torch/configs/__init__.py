from repro_torch.configs.base import (INPUT_SHAPES, SHAPES_BY_NAME,
                                      EncDecConfig, FedTimeConfig,
                                      HybridConfig, InputShape, MoEConfig,
                                      ModelConfig, SSMConfig, VLMConfig,
                                      XLSTMConfig)
from repro_torch.configs.registry import (ALL_ARCHS, ASSIGNED_ARCHS,
                                          get_config, get_smoke_config)

__all__ = [
    "EncDecConfig", "FedTimeConfig", "HybridConfig", "InputShape",
    "MoEConfig", "ModelConfig", "SSMConfig", "VLMConfig", "XLSTMConfig",
    "ALL_ARCHS", "ASSIGNED_ARCHS", "INPUT_SHAPES", "SHAPES_BY_NAME",
    "get_config", "get_smoke_config",
]
