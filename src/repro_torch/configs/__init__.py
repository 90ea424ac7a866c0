"""Model configs of the port: every architecture of the reference, and
the shape cells of the dry run."""
from .base import (ARCH_IDS, DEFAULT_RULES, LM_SHAPES, PORTED_ARCHS, Group, LayerSpec,
                   ModelConfig, ShapeConfig, get_config, get_smoke_config,
                   long_context_ok, rules_for, shapes_for)

__all__ = ["ARCH_IDS", "DEFAULT_RULES", "LM_SHAPES", "PORTED_ARCHS", "Group", "LayerSpec",
           "ModelConfig", "ShapeConfig", "get_config", "get_smoke_config",
           "long_context_ok", "rules_for", "shapes_for"]
