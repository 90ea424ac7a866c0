"""Dense decoder-only models on the division unit's consumers."""
from . import attention, layers, model, params
from .model import forward, make_cache
from .params import init_params, param_count

__all__ = ["attention", "layers", "model", "params", "forward", "make_cache",
           "init_params", "param_count"]
