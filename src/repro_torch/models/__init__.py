"""Decoder-only models (dense, sliding-window, MoE) on the division unit's
consumers."""
from . import attention, layers, model, moe, params
from .model import forward, make_cache
from .params import active_param_count, init_params, param_count

__all__ = ["attention", "layers", "model", "moe", "params", "forward",
           "make_cache", "init_params", "param_count", "active_param_count"]
