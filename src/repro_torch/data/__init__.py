"""The synthetic LM data pipeline (numpy; seekable and host-sharded)."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
