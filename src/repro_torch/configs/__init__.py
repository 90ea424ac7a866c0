"""Model configs of the port: every architecture of the reference."""
from .base import (ARCH_IDS, DEFAULT_RULES, PORTED_ARCHS, Group, LayerSpec,
                   ModelConfig, get_config, get_smoke_config, rules_for)

__all__ = ["ARCH_IDS", "DEFAULT_RULES", "PORTED_ARCHS", "Group", "LayerSpec",
           "ModelConfig", "get_config", "get_smoke_config", "rules_for"]
