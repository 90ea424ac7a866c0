"""Model configs of the port: every architecture of the reference."""
from .base import (ARCH_IDS, PORTED_ARCHS, Group, LayerSpec, ModelConfig,
                   get_config, get_smoke_config)

__all__ = ["ARCH_IDS", "PORTED_ARCHS", "Group", "LayerSpec", "ModelConfig",
           "get_config", "get_smoke_config"]
