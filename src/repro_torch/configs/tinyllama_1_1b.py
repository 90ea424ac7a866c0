"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 (arXiv:2401.02385). The same model as
``src/repro/configs/tinyllama_1_1b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632,
    vocab=32_000,
    train_microbatch_size=8,
)

SMOKE_CONFIG = ModelConfig(
    name="tinyllama-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128,
    vocab=256,
    remat=False,
)
