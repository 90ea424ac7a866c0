"""The reference's models (dense, sliding-window, MoE, Mamba-2 and hybrid,
encoder-decoder, embedding-input) on the division unit's consumers."""
from . import attention, layers, mamba2, model, moe, params
from .model import forward, make_cache
from .params import abstract_params, active_param_count, init_params, param_count

__all__ = ["attention", "layers", "mamba2", "model", "moe", "params", "forward",
           "make_cache", "init_params", "abstract_params", "param_count",
           "active_param_count"]
