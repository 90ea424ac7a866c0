"""AdamW through the division unit, LR schedules and int8 gradient
compression."""
from . import adamw, compress, schedule
from .adamw import AdamWConfig

__all__ = ["adamw", "compress", "schedule", "AdamWConfig"]
