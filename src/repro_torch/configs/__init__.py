"""Model configs of the port: the dense, sliding-window and MoE architectures."""
from .base import (ARCH_IDS, PORTED_ARCHS, Group, LayerSpec, ModelConfig,
                   get_config, get_smoke_config)

__all__ = ["ARCH_IDS", "PORTED_ARCHS", "Group", "LayerSpec", "ModelConfig",
           "get_config", "get_smoke_config"]
