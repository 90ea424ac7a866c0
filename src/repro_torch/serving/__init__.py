"""Serving: prefill + greedy decode, static and continuous batching."""
from .engine import (Request, ServingEngine, alignment, decode_step, pad_cache_to,
                     prefill)

__all__ = ["Request", "ServingEngine", "alignment", "decode_step", "pad_cache_to",
           "prefill"]
