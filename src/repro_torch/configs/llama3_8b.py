"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 (arXiv:2407.21783). The same model as
``src/repro/configs/llama3_8b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336,
    vocab=128_256,
    rope_theta=500_000.0,
    train_microbatch_size=4,
)

SMOKE_CONFIG = ModelConfig(
    name="llama3-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab=512,
    rope_theta=500_000.0,
    remat=False,
)
